from davinci_tpu_torch.storage.kv import MemoryKV, SQLiteKV
from davinci_tpu_torch.storage.storage import Storage, VoteIDStatus

__all__ = ["MemoryKV", "SQLiteKV", "Storage", "VoteIDStatus"]
