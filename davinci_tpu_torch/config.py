"""Node configuration: every knob has a DAVINCI_* environment variable and
a CLI flag, mirroring the reference's pflag+viper scheme where each flag
maps to a DAVINCI_* env (cmd/davinci-sequencer/config.go:36-120)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields


def _env(name: str, default, cast):
    v = os.environ.get(f"DAVINCI_{name}")
    if v is None:
        return default
    if cast is bool:
        return v.lower() in ("1", "true", "yes", "on")
    return cast(v)


@dataclass
class Config:
    """Resolution order: explicit kwargs > DAVINCI_* env > defaults."""

    log_level: str = "info"            # DAVINCI_LOG_LEVEL
    api_port: int = 8080               # DAVINCI_API_PORT
    db_path: str = ""                  # DAVINCI_DB_PATH (empty: in-memory)
    batch_time_window: float = 300.0   # DAVINCI_BATCH_TIME_WINDOW (seconds)
    votes_per_batch: int = 60          # DAVINCI_VOTES_PER_BATCH
    tick_interval: float = 1.0         # DAVINCI_TICK_INTERVAL
    worker_seed: str = ""              # DAVINCI_WORKER_SEED (enables farm)
    worker_master_url: str = ""        # DAVINCI_WORKER_MASTER_URL
    worker_name: str = "worker"        # DAVINCI_WORKER_NAME
    artifacts_dir: str = ""            # DAVINCI_ARTIFACTS_DIR
    force_cleanup: bool = False        # DAVINCI_FORCE_CLEANUP
    prover_mode: str = "stub"          # DAVINCI_PROVER_MODE (stub|solve|prove)
    max_dl_bound: int = 10**12         # DAVINCI_MAX_DL_BOUND (BSGS bound)
    cell_proofs: bool = False          # DAVINCI_CELL_PROOFS (EIP-7594 sidecar)

    _ENV_CASTS = {
        "log_level": str, "api_port": int, "db_path": str,
        "batch_time_window": float, "votes_per_batch": int,
        "tick_interval": float, "worker_seed": str,
        "worker_master_url": str, "worker_name": str, "artifacts_dir": str,
        "force_cleanup": bool, "prover_mode": str, "max_dl_bound": int,
        "cell_proofs": bool,
    }

    @classmethod
    def from_env(cls, **overrides) -> "Config":
        kwargs = {}
        for f in fields(cls):
            if f.name.startswith("_"):
                continue
            cast = cls._ENV_CASTS[f.name]
            kwargs[f.name] = _env(f.name.upper(), f.default, cast)
        kwargs.update(overrides)
        return cls(**kwargs)

    def apply(self):
        """Side effects: logger level + artifacts dir."""
        from davinci_tpu_torch import log

        log.init(self.log_level)
        if self.artifacts_dir:
            os.environ["DAVINCI_ARTIFACTS_DIR"] = self.artifacts_dir
