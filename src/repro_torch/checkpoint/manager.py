"""Round-granular atomic checkpointing (fault tolerance; DESIGN.md §7).
Port of ``repro/checkpoint/manager.py``.

Layout:
  <dir>/step_<round>/
      server.pkl          — params, server optimizer/algorithm state, RNG,
                            estimator history, round counter, engine
                            in-flight state (async pipeline / semi-sync
                            carry pool; see RoundEngine.state_dict)
      state/              — client-state shard files (hard-linked from the
                            state managers; incremental)
      MANIFEST.json       — written LAST; a checkpoint without a manifest is
                            treated as torn and ignored on restore
  <dir>/LATEST            — text file naming the newest complete step

Writes go to a temp dir then ``os.replace`` into place, so a crash mid-save
never corrupts the previous checkpoint.  The manifest additionally records a
sha256 digest of the params (``params_digest``); ``restore`` re-computes it
from the loaded blob and refuses a checkpoint whose bytes rotted or were
tampered with *before* mutating the server — a failed restore leaves the
server untouched.  ``restore_latest`` walks backwards past torn AND corrupt
checkpoints.  ``keep`` bounds retained checkpoints (GC).

The blob holds host data only: every tensor in it is a CPU tensor (which
keeps bf16 without numpy's help), so a checkpoint written on the card
restores on the CPU and the other way round; ``restore`` moves tensors onto
the server's device.  Its classes are the port's own, so a JAX checkpoint
does not restore here.

Crash recovery (DESIGN.md §10): the blob carries the executor topology, so
``ParrotServer.run(..., auto_resume=True)`` after a mid-round kill restores
the last durable round boundary — executors missing from the saved live
set are retired on restore — and replays the remaining rounds
deterministically.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.core.engine import _on
from repro_torch.core.state_manager import _host_tree


def params_digest(params: Any) -> str:
    """sha256 over the params tree's leaves (host bytes, in tree order,
    shape/dtype tagged so a reshaped-but-identical buffer cannot collide).
    The integrity check for checkpoint blobs — and the equality witness the
    resume tests compare across runs.  Each leaf is tagged as the JAX
    package tags it (numpy's dtype name, ``float32`` or ``bfloat16``, and
    the shape tuple) over its raw little-endian bytes, so the same params
    give the same hex digest in both packages."""
    h = hashlib.sha256()
    for leaf in tree.leaves(params):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to("cpu").contiguous()
            h.update(str(t.dtype).removeprefix("torch.").encode())
            h.update(str(tuple(t.shape)).encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            arr = np.asarray(leaf)
            h.update(str(arr.dtype).encode())
            h.update(str(arr.shape).encode())
            h.update(arr.tobytes())
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, every_rounds: int = 1, keep: int = 3):
        self.directory = directory
        self.every_rounds = every_rounds
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def _step_dir(self, rnd: int) -> str:
        return os.path.join(self.directory, f"step_{rnd:08d}")

    def save(self, server: Any) -> str:
        rnd = server.round
        final = self._step_dir(rnd)
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_ckpt_")
        try:
            blob = {
                "round": rnd,
                "params": _host_tree(server.params),
                "server_state": _host_tree(server.server_state),
                "rng_state": server.rng.bit_generator.state,
                "estimator_records": {
                    k: list(v) for k, v in server.estimator._records.items()},
                # the *fitted* models too: the async engine consults
                # last_fit between schedules (steal victims) — a resume
                # that refits lazily would diverge
                "estimator_fit": dict(server.estimator.last_fit),
                "history": server.history,
                "executor_ids": sorted(server.executors),
                # engine in-flight state (async pipeline / semi-sync carry):
                # host-side plain data via RoundEngine.state_dict, so a
                # restore resumes the discrete-event pipeline exactly where
                # the save left it (None for the stateless BSP engine)
                "engine": server.engine.state_dict(),
                "virtual_now": server.virtual_now,
                # the network model's anchors: the last broadcast's size and
                # the compressor's achieved wire ratio price the next
                # round's comm predictions and schedule
                "last_payload_nbytes": server._last_payload_nbytes,
                "wire_ratio": server._wire_ratio,
                # the fault injector's fired one-shot events and retry
                # budgets: a resumed run replays the remaining faults
                "faults": (server.faults.state_dict()
                           if server.faults is not None else None),
                # the control plane and telemetry come with item 16
                "control": None,
                # compressor state (top-k error-feedback residuals, PowerSGD
                # P/Q warm starts): without it a resume under compression
                # silently diverges from the uninterrupted run.  hasattr-
                # guarded: duck-typed custom compressors without state_dict
                # checkpoint as stateless.
                "compressor": (server.compressor.state_dict()
                               if server.compressor is not None
                               and hasattr(server.compressor, "state_dict")
                               else None),
                "telemetry": None,
                "time": time.time(),
            }
            digest = params_digest(blob["params"])
            with open(os.path.join(tmp, "server.pkl"), "wb") as f:
                pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)
            # client-state shards (stateful algorithms); executors usually
            # share one manager — flush each distinct manager once
            state_dir = os.path.join(tmp, "state")
            seen = set()
            for ex in server.executors.values():
                sm = ex.state_manager
                if sm is not None and id(sm) not in seen:
                    seen.add(id(sm))
                    sm.checkpoint(state_dir)
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump({"round": rnd, "complete": True,
                           "params_digest": digest}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        with open(os.path.join(self.directory, "LATEST.tmp"), "w") as f:
            f.write(os.path.basename(final))
        os.replace(os.path.join(self.directory, "LATEST.tmp"),
                   os.path.join(self.directory, "LATEST"))
        self._gc()
        return final

    def maybe_save(self, server: Any) -> Optional[str]:
        if server.round % self.every_rounds == 0:
            return self.save(server)
        return None

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for d in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, server: Any, step_dir: str) -> int:
        # load + verify BEFORE touching the server: a corrupt blob (bit rot,
        # torn write that somehow kept its manifest, tampering) must raise
        # with the server still in its pre-restore state
        with open(os.path.join(step_dir, "server.pkl"), "rb") as f:
            blob = pickle.load(f)
        manifest_path = os.path.join(step_dir, "MANIFEST.json")
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                manifest = json.load(f)
            want = manifest.get("params_digest")
            if want is not None and params_digest(blob["params"]) != want:
                raise ValueError(
                    f"checkpoint {step_dir} failed integrity check: params "
                    f"digest mismatch (expected {want[:12]}…)")
        dev = server.device
        server.params = _on(blob["params"], dev)
        server.server_state = _on(blob["server_state"], dev)
        server.rng.bit_generator.state = blob["rng_state"]
        server.estimator._records.clear()
        for k, v in blob["estimator_records"].items():
            server.estimator._records[int(k)] = list(v)
        server.estimator.last_fit = dict(blob.get("estimator_fit", {}))
        server.history = list(blob["history"])
        server.round = blob["round"]
        server.virtual_now = float(blob.get("virtual_now", 0.0))
        server._last_payload_nbytes = int(blob.get("last_payload_nbytes", 0))
        server._wire_ratio = float(blob.get("wire_ratio", 1.0))
        # every restored tensor lands on the server's device: an in-flight
        # partial left on the host would fold through the plain version
        server.engine.load_state_dict(blob.get("engine"), device=dev)
        if server.faults is not None:
            server.faults.load_state_dict(blob.get("faults"))
        if server.compressor is not None \
                and hasattr(server.compressor, "load_state_dict"):
            server.compressor.load_state_dict(blob.get("compressor"))
        # reconcile the executor topology with the checkpointed one: a
        # fresh server is constructed with the FULL executor set, but the
        # saved run may have had some crashed — retire those so the resumed
        # run schedules on the same live set.  Executors the blob knows but
        # this server lacks can't be conjured — that is a configuration
        # error the engines will surface.
        want_ids = set(blob.get("executor_ids", server.executors))
        for k in sorted(set(server.executors) - want_ids):
            server._drop_executor(k)
        for k in sorted(want_ids - set(server.executors)):
            server._revive_executor(k)
        state_dir = os.path.join(step_dir, "state")
        if os.path.isdir(state_dir):
            seen = set()
            for ex in server.executors.values():
                sm = ex.state_manager
                if sm is not None and id(sm) not in seen:
                    seen.add(id(sm))
                    sm.restore(state_dir)
        return server.round


def restore_latest(server: Any, directory: str) -> Optional[int]:
    """Restore the newest complete checkpoint; walks past torn ones."""
    mgr = CheckpointManager(directory)
    latest = os.path.join(directory, "LATEST")
    candidates: List[str] = []
    if os.path.exists(latest):
        with open(latest) as f:
            candidates.append(os.path.join(directory, f.read().strip()))
    candidates.extend(sorted(
        (os.path.join(directory, d) for d in os.listdir(directory)
         if d.startswith("step_")), reverse=True))
    seen = set()
    for cand in candidates:
        if cand in seen or not os.path.isdir(cand):
            continue
        seen.add(cand)
        manifest = os.path.join(cand, "MANIFEST.json")
        if not os.path.exists(manifest):
            continue  # torn checkpoint
        try:
            with open(manifest) as f:
                if not json.load(f).get("complete"):
                    continue
            return mgr.restore(server, cand)
        except Exception:
            continue
    return None
