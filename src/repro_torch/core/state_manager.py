"""Client state manager for stateful FL algorithms (paper §3.4).  Port of
``repro/core/state_manager.py``.

Simulating M stateful clients needs O(s_d · M) state which cannot live in
accelerator (or even host) memory at scale; Parrot's manager keeps a bounded
in-memory working set and spills the rest below.  Memory becomes O(s_d · K)
(one live state per executor) and disk O(s_d · M) — Table 1.

Million-client layout (DESIGN.md §11) — three tiers, shard-granular below
tier 0:

  tier 0  per-client LRU of live states (tensors on the card via
          ``keep_device=True``), bounded by ``memory_budget_bytes``.
  tier 1  host-RAM shard cache: evicted states pack into fixed-size shards
          of ``shard_clients`` consecutive ids (``shard_of = id //
          shard_clients``), LRU-bounded by ``shard_cache_bytes``.
  disk    one pickle file *per shard*, not per client — 1M clients at the
          default shard size is ~16k inodes, not 1M.

Spilled dirty states are content-digested: an eviction whose bytes already
match the on-disk copy never rewrites it, and clean evictions never touch
disk at all (their value always has a live copy in a lower tier).
``prefetch(ids)`` — keyed by the engine's schedule (the next chunk's client
ids) — stages whole shards into tier 1 ahead of the executor reaching them,
so state loads overlap compute on the virtual clock and never double-read
the disk.

Multi-host design: client ids are hash-partitioned across hosts
(``owner_host``); each host's manager only ever holds its shard, so the
aggregate footprint scales with hosts.  The manager is checkpointable
(incremental and shard-granular: only dirty shards are rewritten, clean
ones are hard-linked) for fault tolerance.

Host copies are CPU tensors, which keep bf16 (``Tensor.numpy()`` refuses
it); digests hash each leaf's raw bytes with its dtype and shape.
"""
from __future__ import annotations

import collections
import hashlib
import json
import os
import pickle
import shutil
import tempfile
import threading
from typing import Any, Dict, Iterable, List, Optional

import torch

from repro_torch.core import tree


def owner_host(client_id: int, n_hosts: int) -> int:
    """Deterministic hash partition of client state ownership."""
    h = hashlib.blake2s(str(client_id).encode(), digest_size=4).digest()
    return int.from_bytes(h, "little") % max(n_hosts, 1)


def _tree_bytes(state: Any) -> int:
    return sum(a.nbytes for a in tree.leaves(state)
               if hasattr(a, "nbytes"))


def _host_tree(state: Any) -> Any:
    """Host copy of a state: every tensor as a fresh CPU tensor (a copy
    even on the CPU, so the store never aliases a caller's tensor)."""
    return tree.map(lambda t: t.detach().to("cpu", copy=True)
                    if isinstance(t, torch.Tensor) else t, state)


def _digest(host_tree: Any) -> bytes:
    h = hashlib.blake2s()
    leaves, treedef = tree.flatten(host_tree)
    h.update(repr(treedef).encode())
    for t in leaves:
        if isinstance(t, torch.Tensor):
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.contiguous().reshape(-1).view(torch.uint8)
                     .numpy().tobytes())
        else:
            h.update(pickle.dumps(t, protocol=pickle.HIGHEST_PROTOCOL))
    return h.digest()


class ClientStateManager:
    """Tiered LRU store: per-client RAM over shard-file disk spill.

    Parameters
    ----------
    spill_dir: directory for spilled / checkpointed shard files.
    memory_budget_bytes: tier-0 (per-client) working-set bound; 0 ->
        unbounded (useful for measuring the no-manager baseline).
    shard_clients: ids per shard file (``shard = id // shard_clients``).
    shard_cache_bytes: tier-1 (host-RAM shard cache) bound; None mirrors
        ``memory_budget_bytes``, 0 -> unbounded.
    """

    def __init__(self, spill_dir: str, memory_budget_bytes: int = 1 << 28,
                 host: int = 0, n_hosts: int = 1,
                 shard_clients: int = 64,
                 shard_cache_bytes: Optional[int] = None):
        self.spill_dir = spill_dir
        self.memory_budget = memory_budget_bytes
        self.host = host
        self.n_hosts = n_hosts
        self.shard_clients = max(int(shard_clients), 1)
        self.shard_cache_budget = (memory_budget_bytes
                                   if shard_cache_bytes is None
                                   else shard_cache_bytes)
        os.makedirs(spill_dir, exist_ok=True)
        # tier 0: client -> state (LRU; device arrays allowed)
        self._mem: "collections.OrderedDict[int, Any]" = collections.OrderedDict()
        self._mem_bytes = 0
        self._dirty: set = set()
        # tier 1: shard id -> {client: host state} (LRU over shards)
        self._shards: "collections.OrderedDict[int, Dict[int, Any]]" = \
            collections.OrderedDict()
        self._shard_bytes = 0
        self._shard_dirty: set = set()
        # disk: shard id -> clients present in the shard file
        self._disk_clients: Dict[int, set] = {}
        # content digests: on-disk value per client, and values staged in
        # tier 1 awaiting a flush (promoted to ``_digests`` on write)
        self._digests: Dict[int, bytes] = {}
        self._staged: Dict[int, bytes] = {}
        self._lock = threading.RLock()
        self.stats = {"hits": 0, "misses": 0, "spills": 0, "loads": 0,
                      "disk_loads": 0, "disk_writes": 0, "prefetched": 0,
                      "skipped_rewrites": 0}

    # ------------------------------------------------------------------ io
    def shard_of(self, client: int) -> int:
        return int(client) // self.shard_clients

    def _shard_path(self, sid: int) -> str:
        return os.path.join(self.spill_dir,
                            f"shard_{self.host}_{sid:06d}.pkl")

    def _read_shard_file(self, sid: int) -> Dict[int, Any]:
        with open(self._shard_path(sid), "rb") as f:
            return pickle.load(f)

    def _write_shard_file(self, sid: int, contents: Dict[int, Any]) -> None:
        path = self._shard_path(sid)
        fd, tmp = tempfile.mkstemp(dir=self.spill_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(contents, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)                             # atomic
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.stats["disk_writes"] += 1

    def _flush_shard(self, sid: int) -> None:
        """Write one dirty shard: merge its RAM entries over whatever else
        the shard file holds (RAM is newer), one file write for the whole
        shard."""
        ram = self._shards.get(sid, {})
        on_disk = self._disk_clients.get(sid, set())
        merged = dict(ram)
        missing = on_disk - merged.keys()
        if missing:
            try:
                old = self._read_shard_file(sid)
            except OSError:
                old = {}
            for c in missing:
                if c in old:
                    merged[c] = old[c]
        if merged:
            self._write_shard_file(sid, merged)
            self._disk_clients[sid] = set(merged)
        else:
            try:
                os.unlink(self._shard_path(sid))
            except OSError:
                pass
            self._disk_clients.pop(sid, None)
        for c in ram:
            if c in self._staged:
                self._digests[c] = self._staged.pop(c)
        self._shard_dirty.discard(sid)

    def _load_shard(self, sid: int) -> None:
        """Read one shard file into tier 1 (RAM entries win — they are
        staged newer values)."""
        try:
            disk = self._read_shard_file(sid)
        except OSError:
            return
        self.stats["disk_loads"] += 1
        ram = self._shards.get(sid)
        if ram is None:
            ram = self._shards[sid] = {}
        for c, st in disk.items():
            if c not in ram:
                ram[c] = st
                self._shard_bytes += _tree_bytes(st)
        self._shards.move_to_end(sid)

    def _evict_shards(self) -> None:
        while (self.shard_cache_budget
               and self._shard_bytes > self.shard_cache_budget
               and self._shards):
            sid = next(iter(self._shards))                     # LRU shard
            if sid in self._shard_dirty:
                self._flush_shard(sid)
            contents = self._shards.pop(sid)
            self._shard_bytes -= sum(_tree_bytes(t)
                                     for t in contents.values())

    def _stage(self, client: int, host_tree: Any, dig: bytes) -> None:
        """Place one host state into its tier-1 shard and mark the shard
        dirty (it now differs from its file)."""
        sid = self.shard_of(client)
        sh = self._shards.get(sid)
        if sh is None:
            sh = self._shards[sid] = {}
        if client in sh:
            self._shard_bytes -= _tree_bytes(sh[client])
        sh[client] = host_tree
        self._shard_bytes += _tree_bytes(host_tree)
        self._shards.move_to_end(sid)
        self._shard_dirty.add(sid)
        self._staged[client] = dig
        self._evict_shards()

    def _spill_one(self) -> None:
        """Evict the LRU tier-0 state.  Clean states drop (their value is
        already live in a lower tier — never touches disk); dirty states
        content-digest first and skip the restage when the bytes already
        match what the lower tiers hold (no redundant rewrite of
        byte-identical state)."""
        client, st = self._mem.popitem(last=False)          # LRU eviction
        self._mem_bytes -= _tree_bytes(st)
        self.stats["spills"] += 1
        if client not in self._dirty:
            return
        self._dirty.discard(client)
        host_tree = _host_tree(st)
        dig = _digest(host_tree)
        pending = self._staged.get(client)
        if pending is not None:
            if pending == dig:                 # staged copy already matches
                self.stats["skipped_rewrites"] += 1
                return
        elif self._digests.get(client) == dig:  # on-disk copy matches
            self.stats["skipped_rewrites"] += 1
            return
        self._stage(client, host_tree, dig)

    # ----------------------------------------------------------------- api
    def save(self, client: int, state: Any, keep_device: bool = False) -> None:
        """``Save_State`` in Algorithm 2.

        ``keep_device=True`` stores the state's tensors as they are —
        tensors on the card stay there (no blocking host copy on the
        dispatch path); they are copied to the host only if/when the LRU
        spills them."""
        assert owner_host(client, self.n_hosts) == self.host or self.n_hosts == 1, \
            f"client {client} not owned by host {self.host}"
        with self._lock:
            if not keep_device:
                state = _host_tree(state)
            if client in self._mem:
                self._mem_bytes -= _tree_bytes(self._mem.pop(client))
            self._mem[client] = state
            self._mem_bytes += _tree_bytes(state)
            self._dirty.add(client)
            while self.memory_budget and self._mem_bytes > self.memory_budget \
                    and len(self._mem) > 1:
                self._spill_one()

    def load(self, client: int, default: Any = None) -> Any:
        """``Load_State`` in Algorithm 2 (LRU touch).  Misses fill from the
        shard RAM tier, then from the shard file (which stages the whole
        shard in tier 1 — the read granularity prefetch exploits)."""
        with self._lock:
            if client in self._mem:
                self.stats["hits"] += 1
                self._mem.move_to_end(client)
                return self._mem[client]
            sid = self.shard_of(client)
            sh = self._shards.get(sid)
            if sh is None or client not in sh:
                if client in self._disk_clients.get(sid, ()):
                    self._load_shard(sid)
                    sh = self._shards.get(sid)
            if sh is not None and client in sh:
                self.stats["misses"] += 1
                self.stats["loads"] += 1
                st = sh[client]
                self._shards.move_to_end(sid)
                self._mem[client] = st
                self._mem_bytes += _tree_bytes(st)
                while self.memory_budget \
                        and self._mem_bytes > self.memory_budget \
                        and len(self._mem) > 1:
                    self._spill_one()
                self._evict_shards()
                return st
            return default

    def prefetch(self, clients: Iterable[int]) -> int:
        """Schedule-keyed look-ahead: stage the shards holding ``clients``
        into the RAM tier *without* touching the tier-0 LRU, so the
        upcoming ``load_many`` never reads disk for them.  Returns the
        number of ids actually staged (already-resident ids cost
        nothing — prefetched ids never double-load)."""
        staged = 0
        with self._lock:
            for client in clients:
                client = int(client)
                if client in self._mem:
                    continue
                sid = self.shard_of(client)
                sh = self._shards.get(sid)
                if sh is not None and client in sh:
                    continue
                if client in self._disk_clients.get(sid, ()):
                    self._load_shard(sid)
                    if client in self._shards.get(sid, ()):
                        staged += 1
            if staged:
                self.stats["prefetched"] += staged
                self._evict_shards()
        return staged

    def save_many(self, states: Dict[int, Any],
                  keep_device: bool = False) -> None:
        """Batched ``Save_State`` for a block of B clients (one lock trip —
        the executor writes a whole vmapped block back in one call; the
        RLock makes the nested per-client saves free)."""
        with self._lock:
            for client, state in states.items():
                self.save(client, state, keep_device=keep_device)

    def load_many(self, clients: Iterable[int], default: Any = None,
                  device: Any = None) -> List[Any]:
        """Batched ``Load_State``: one state per client, in order, under a
        single lock acquisition (the executor stacks the results for the
        vmapped scan).  ``device`` places each loaded state onto the
        requesting executor's device (host→device for spilled numpy states,
        a direct D2D copy for states another executor left resident
        elsewhere, and a no-op for states already home)."""
        with self._lock:
            out = [self.load(client, default) for client in clients]
        if device is not None:
            out = [s if s is None else
                   tree.map(lambda t: t.to(device), s) for s in out]
        return out

    def __contains__(self, client: int) -> bool:
        if client in self._mem:
            return True
        sid = self.shard_of(client)
        return (client in self._shards.get(sid, ())
                or client in self._disk_clients.get(sid, ()))

    def known_clients(self) -> List[int]:
        known = set(self._mem)
        for sh in self._shards.values():
            known.update(sh)
        for clients in self._disk_clients.values():
            known.update(clients)
        return sorted(known)

    @property
    def memory_bytes(self) -> int:
        return self._mem_bytes

    @property
    def shard_ram_bytes(self) -> int:
        return self._shard_bytes

    def disk_bytes(self) -> int:
        tot = 0
        for sid, clients in self._disk_clients.items():
            if not clients:
                continue
            try:
                tot += os.path.getsize(self._shard_path(sid))
            except OSError:
                pass
        return tot

    def stats_snapshot(self) -> Dict[str, float]:
        """Cumulative counters plus current tier byte gauges (the
        ``*_bytes`` keys) — what the server surfaces into
        ``RoundMetrics.extra["state_manager"]`` each round."""
        with self._lock:
            snap: Dict[str, float] = dict(self.stats)
            snap["mem_bytes"] = self._mem_bytes
            snap["shard_ram_bytes"] = self._shard_bytes
            snap["disk_bytes"] = self.disk_bytes()
            return snap

    # -------------------------------------------------------- checkpointing
    def checkpoint(self, ckpt_dir: str) -> None:
        """Flush dirty state shard-granularly and hard-link the shard files
        into a checkpoint directory (incremental: clean shards are only
        linked, and states byte-identical to their durable copy are not
        rewritten)."""
        os.makedirs(ckpt_dir, exist_ok=True)
        with self._lock:
            for client in sorted(self._dirty):
                host_tree = _host_tree(self._mem[client])
                dig = _digest(host_tree)
                pending = self._staged.get(client)
                if pending is not None:
                    if pending == dig:
                        self.stats["skipped_rewrites"] += 1
                        continue
                elif self._digests.get(client) == dig:
                    self.stats["skipped_rewrites"] += 1
                    continue
                self._stage(client, host_tree, dig)
            self._dirty.clear()
            for sid in sorted(self._shard_dirty):
                self._flush_shard(sid)
            manifest = {
                "host": self.host, "n_hosts": self.n_hosts,
                "shard_clients": self.shard_clients,
                "clients": sorted(
                    c for cl in self._disk_clients.values() for c in cl),
                "shards": {str(sid): sorted(cl)
                           for sid, cl in sorted(self._disk_clients.items())
                           if cl},
            }
            for sid, clients in self._disk_clients.items():
                if not clients:
                    continue
                dst = os.path.join(ckpt_dir,
                                   os.path.basename(self._shard_path(sid)))
                if os.path.exists(dst):
                    os.unlink(dst)
                try:
                    os.link(self._shard_path(sid), dst)
                except OSError:
                    shutil.copy2(self._shard_path(sid), dst)
            with open(os.path.join(ckpt_dir,
                                   f"state_manifest_{self.host}.json"),
                      "w") as f:
                json.dump(manifest, f)
            self._evict_shards()

    def restore(self, ckpt_dir: str) -> int:
        """Re-adopt a checkpointed shard set; returns number of clients
        restored."""
        path = os.path.join(ckpt_dir, f"state_manifest_{self.host}.json")
        if not os.path.exists(path):
            return 0
        with open(path) as f:
            manifest = json.load(f)
        with self._lock:
            # adopt-exactly: drop any state not in the manifest (a later
            # round's leftovers would otherwise leak into the replay)
            self._mem.clear()
            self._mem_bytes = 0
            self._dirty.clear()
            self._shards.clear()
            self._shard_bytes = 0
            self._shard_dirty.clear()
            self._digests.clear()
            self._staged.clear()
            for sid in list(self._disk_clients):
                try:
                    os.unlink(self._shard_path(sid))
                except OSError:
                    pass
            self._disk_clients.clear()
            self.shard_clients = int(manifest.get("shard_clients",
                                                  self.shard_clients))
            n = 0
            for sid_str, clients in manifest.get("shards", {}).items():
                sid = int(sid_str)
                src = os.path.join(ckpt_dir,
                                   os.path.basename(self._shard_path(sid)))
                if not os.path.exists(src):
                    continue
                dst = self._shard_path(sid)
                # checkpoints hard-link shard files, so a restore into the
                # original spill dir may find dst already IS src (same
                # inode) — copying onto itself would raise SameFileError
                if not (os.path.exists(dst) and os.path.samefile(src, dst)):
                    shutil.copy2(src, dst)
                self._disk_clients[sid] = set(int(c) for c in clients)
                n += len(clients)
        return n

    def rebalance(self, new_n_hosts: int,
                  peers: Dict[int, "ClientStateManager"]) -> int:
        """Elastic membership change: re-hash ownership and hand off states
        that now belong to other hosts.  Returns number moved."""
        moved = 0
        with self._lock:
            for client in self.known_clients():
                new_owner = owner_host(client, new_n_hosts)
                if new_owner == self.host:
                    continue
                state = self.load(client)
                peers[new_owner].save(client, state)
                self._discard(client)
                moved += 1
            for sid in sorted(self._shard_dirty):
                self._flush_shard(sid)
        self.n_hosts = new_n_hosts
        return moved

    def _discard(self, client: int) -> None:
        """Forget one client everywhere (rebalance hand-off)."""
        if client in self._mem:
            self._mem_bytes -= _tree_bytes(self._mem.pop(client))
        self._dirty.discard(client)
        sid = self.shard_of(client)
        sh = self._shards.get(sid)
        if sh is not None and client in sh:
            self._shard_bytes -= _tree_bytes(sh.pop(client))
        on_disk = self._disk_clients.get(sid)
        if on_disk is not None and client in on_disk:
            on_disk.discard(client)
            self._shard_dirty.add(sid)   # file must shed the moved entry
        self._digests.pop(client, None)
        self._staged.pop(client, None)
