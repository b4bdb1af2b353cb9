"""Circuit artifact store: content-addressed PK/VK cache with load-or-setup
semantics, and the CircuitRuntime bundle used by every prover call site.

Role parity: reference circuits/artifacts.go — `Artifact.loadOrDownload`
(:74), `NewCircuitArtifacts` (:291), `LoadOrDownload` (:330), `Setup`
(:474), `ProveAndVerify` (:543).  We have no remote download tier (no
egress); artifacts are produced locally by `load_or_setup` (the
cmd/circuit-compile role) and cached under DAVINCI_ARTIFACTS_DIR, keyed by
circuit id + R1CS structure hash, so trusted setup runs once per circuit
structure — never inline at prove sites.
"""

from __future__ import annotations

import json
import os
import pathlib
import threading

from davinci_tpu_torch import log
from davinci_tpu_torch.groth16 import Groth16
from davinci_tpu_torch.groth16.serialize import (
    cs_structure_hash,
    read_pk,
    solved_from_bytes,
    solved_to_bytes,
    vk_from_bytes,
    vk_to_bytes,
    write_pk,
)


def default_artifacts_dir() -> pathlib.Path:
    env = os.environ.get("DAVINCI_ARTIFACTS_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".davinci-tpu" / "artifacts"


class CircuitRuntime:
    """ccs+pk+vk bundle with prove/verify methods (reference CircuitRuntime,
    circuits/artifacts.go:510-571)."""

    def __init__(
        self, circuit_id: str, curve_name: str, pk, vk, structure_hash: str,
        g16: Groth16 | None = None,
    ):
        self.circuit_id = circuit_id
        self.curve_name = curve_name
        self.g16 = g16 or Groth16(curve_name)
        self.pk = pk
        self.vk = vk
        self.structure_hash = structure_hash

    def prove(self, cs, **kw):
        with log.info_time(
            "circuit.prove", circuit=self.circuit_id, curve=self.curve_name,
            constraints=len(cs.constraints),
        ):
            return self.g16.prove(self.pk, cs, **kw)

    def verify(self, proof, public_inputs) -> bool:
        return self.g16.verify(self.vk, proof, public_inputs)

    def prove_and_verify(self, cs, **kw):
        proof = self.prove(cs, **kw)
        assert self.verify(proof, cs.public_values()), (
            f"{self.circuit_id}: proof failed verification"
        )
        return proof

    def prove_committed(self, build_fn, **kw):
        """Two-phase committed proving (lookup-tier circuits):
        build_fn(challenge, blind) -> solved ConstraintSystem."""
        with log.info_time(
            "circuit.prove_committed", circuit=self.circuit_id,
            curve=self.curve_name,
        ):
            return self.g16.prove_committed(self.pk, build_fn, **kw)

    def prove_committed_reuse(self, cs, **kw):
        """Steady-state committed re-prove: reuse an already-built system
        (fresh blind + in-place challenge re-solve; zero Python
        constraint construction)."""
        with log.info_time(
            "circuit.prove_committed_reuse", circuit=self.circuit_id,
            curve=self.curve_name,
        ):
            return self.g16.prove_committed_reuse(self.pk, cs, **kw)

    def verify_committed(self, proof, public_inputs) -> bool:
        return self.g16.verify_committed(self.vk, proof, public_inputs)

    def prove_and_verify_committed(self, build_fn, public_inputs, **kw):
        proof = self.prove_committed(build_fn, **kw)
        assert self.verify_committed(proof, public_inputs), (
            f"{self.circuit_id}: committed proof failed verification"
        )
        return proof


class ArtifactStore:
    """Disk cache of CircuitRuntimes keyed by (circuit_id, structure hash)."""

    def __init__(self, root: str | os.PathLike | None = None):
        self.root = pathlib.Path(root) if root else default_artifacts_dir()
        self._mem: dict[str, CircuitRuntime] = {}
        self._lock = threading.RLock()

    def _dir(self, circuit_id: str) -> pathlib.Path:
        return self.root / circuit_id

    def load_or_setup(
        self, circuit_id: str, curve_name: str, cs, rng=None,
        check_hash: bool = True, g16=None,
    ) -> CircuitRuntime:
        """Return the cached runtime for this circuit structure, running
        (and persisting) trusted setup exactly once per structure.

        g16: optional prebuilt Groth16 backend (synthetic curve families —
        toy recursion chains — aren't in the name registry)."""
        with self._lock:
            rt = self._mem.get(circuit_id)
            if rt is not None:
                if check_hash and rt.structure_hash != cs_structure_hash(cs):
                    raise ValueError(
                        f"{circuit_id}: circuit structure changed vs cached "
                        "artifacts — bump the circuit id"
                    )
                return rt
            rt = self._load_or_setup_disk(
                circuit_id, curve_name, cs, rng, check_hash, g16
            )
            self._mem[circuit_id] = rt
            return rt

    def _load_or_setup_disk(
        self, circuit_id, curve_name, cs, rng, check_hash, g16=None
    ):
        d = self._dir(circuit_id)
        meta_p, pk_p, vk_p = d / "meta.json", d / "pk.bin", d / "vk.bin"
        shash = cs_structure_hash(cs)
        g16 = g16 or Groth16(curve_name)
        g1spec, g2spec = g16.g1, g16.g2
        if meta_p.exists() and pk_p.exists() and vk_p.exists():
            meta = json.loads(meta_p.read_text())
            if meta.get("structure_hash") == shash or not check_hash:
                try:
                    with log.info_time("artifacts.load", circuit=circuit_id):
                        with pk_p.open("rb") as f:
                            pk = read_pk(f, g1spec, g2spec)
                        vk = vk_from_bytes(vk_p.read_bytes(), g1spec, g2spec)
                    return CircuitRuntime(
                        circuit_id, curve_name, pk, vk, shash, g16
                    )
                except Exception as e:  # stale/old-format artifact
                    log.warnw(
                        "artifacts.unreadable", circuit=circuit_id,
                        error=str(e),
                    )
            log.warnw(
                "artifacts.stale", circuit=circuit_id,
                cached=meta.get("structure_hash", "")[:16], current=shash[:16],
            )
        with log.info_time(
            "artifacts.setup", circuit=circuit_id, curve=curve_name,
            constraints=len(cs.constraints), variables=cs.num_variables,
        ):
            pk, vk = g16.setup(cs, rng=rng)
        d.mkdir(parents=True, exist_ok=True)
        with pk_p.open("wb") as f:
            write_pk(f, pk, g1spec, g2spec)
        vk_p.write_bytes(vk_to_bytes(vk, g1spec, g2spec))
        meta_p.write_text(
            json.dumps(
                {
                    "circuit_id": circuit_id,
                    "curve": curve_name,
                    "structure_hash": shash,
                    "constraints": len(cs.constraints),
                    "variables": cs.num_variables,
                    "public": cs.num_public,
                }
            )
        )
        return CircuitRuntime(circuit_id, curve_name, pk, vk, shash, g16)

    # -- solved-system blobs (CCS compile-once role) ----------------------

    def save_solved(self, circuit_id: str, name: str, cs) -> pathlib.Path:
        """Persist a solved constraint system next to the PK/VK so a fresh
        process proves with zero Python circuit construction
        (groth16/serialize.solved_to_bytes; gnark cached-CCS parity)."""
        d = self._dir(circuit_id)
        d.mkdir(parents=True, exist_ok=True)
        p = d / f"{name}.solved"
        with log.info_time(
            "artifacts.save_solved", circuit=circuit_id, name=name
        ):
            tmp = p.with_suffix(f".solved.tmp{os.getpid()}")
            tmp.write_bytes(solved_to_bytes(cs))
            tmp.replace(p)
        return p

    def load_solved(self, circuit_id: str, name: str):
        """The serialized solved system, or None if absent/unreadable."""
        p = self._dir(circuit_id) / f"{name}.solved"
        if not p.exists():
            return None
        try:
            with log.info_time(
                "artifacts.load_solved", circuit=circuit_id, name=name
            ):
                return solved_from_bytes(p.read_bytes())
        except Exception as e:
            log.warnw(
                "artifacts.solved_unreadable", circuit=circuit_id,
                error=str(e),
            )
            return None


_default_store: ArtifactStore | None = None
_default_lock = threading.Lock()


def default_store() -> ArtifactStore:
    global _default_store
    with _default_lock:
        if _default_store is None:
            _default_store = ArtifactStore()
        return _default_store
