from davinci_tpu_torch.web3.encoding import (
    abi_encode,
    function_selector,
    rlp_encode,
)
from davinci_tpu_torch.web3.blobtx import build_blob_tx, sign_blob_tx
from davinci_tpu_torch.web3.txmanager import TxManager
from davinci_tpu_torch.web3.rpc import JsonRpcClient, Web3Pool

__all__ = [
    "abi_encode",
    "function_selector",
    "rlp_encode",
    "build_blob_tx",
    "sign_blob_tx",
    "TxManager",
    "JsonRpcClient",
    "Web3Pool",
]
