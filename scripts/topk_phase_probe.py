"""Per-phase device time of the fused top-k kernel on a CUDA card, from
the timestamps the kernel writes when it is built with
``-DTOPK_PHASE_STAMPS``.

    python3 scripts/topk_phase_probe.py [--n 1207440] [--k 12074]

Builds ``src/repro_torch/kernels/csrc/topk_compress.cu`` with the port's
nvcc flags and ``-DTOPK_PHASE_STAMPS`` into ``build/probe/``, checks a call
against the plain version bit for bit, then stamps one call with L2 flushed
(cold: ``chip_smoke.Timer``'s flush) and one with x and res left in L2
(warm).  For each of the six phases and five grid syncs it prints the
median and the largest time over blocks in microseconds, with the
timestamp's step (the smallest non-zero difference seen), the card's name
and power limit, and one ``PROBE {...}`` JSON line.  Inputs as
``chip_smoke.py`` phase 2 times them: x ~ 1e-3 N(0, 1), res ~ 1e-4 N(0, 1),
from seed 3.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTERVALS = ("1 read chunk, digit-0 histogram", "grid sync 1",
             "2 merge digit-0 histogram", "grid sync 2",
             "3 pick digit 0, candidates, digit-1 histogram", "grid sync 3",
             "4 pick digit 1, digit-2 histogram", "grid sync 4",
             "5 pick digit 2, block counts", "grid sync 5",
             "6 offsets and write")
STAMPS = len(INTERVALS) + 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1207440)
    ap.add_argument("--k", type=int, default=12074)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("topk_phase_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.topk_compress import topk_with_residual_plain

    out_dir = os.path.join(HERE, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "topk_compress_stamps.so")
    built = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                            "-DTOPK_PHASE_STAMPS", "-o", lib_path,
                            str(_build.CSRC / "topk_compress.cu")],
                           capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{built.stdout}{built.stderr}")
    lib = ctypes.CDLL(lib_path)
    launch = lib.topk_compress_launch
    launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int] + [ctypes.c_void_p] * 5
    for name in ("topk_compress_scratch_words", "topk_compress_blocks"):
        getattr(lib, name).argtypes = [ctypes.c_longlong]
        getattr(lib, name).restype = ctypes.c_longlong
    lib.topk_compress_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]

    n, k = args.n, args.k
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(n, device="cuda", generator=gen) * 1e-3
    res = torch.randn(n, device="cuda", generator=gen) * 1e-4
    idx = torch.empty(k, dtype=torch.int32, device="cuda")
    vals = torch.empty(k, device="cuda")
    new_res = torch.empty(n, device="cuda")
    scratch = torch.empty(lib.topk_compress_scratch_words(n),
                          dtype=torch.int32, device="cuda")
    blocks = int(lib.topk_compress_blocks(n))

    def call():
        rc = launch(x.data_ptr(), res.data_ptr(), n, k, idx.data_ptr(),
                    vals.data_ptr(), new_res.data_ptr(), scratch.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: error {rc}")

    call()
    want = topk_with_residual_plain(x, res, k)
    torch.cuda.synchronize()
    for a, b in zip(want, (idx, vals, new_res)):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError("the stamped kernel differs from plain")

    timer = cs.Timer()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"topk_phase_probe: {card}; n={n} k={k}, {blocks} blocks")
    record = {"card": card, "n": n, "k": k, "blocks": blocks}
    for label, flush in (("cold", True), ("warm", False)):
        if flush:
            timer.flush_buf.zero_()
        torch.cuda.synchronize()
        call()
        torch.cuda.synchronize()
        host = (ctypes.c_ulonglong * (blocks * STAMPS))()
        if lib.topk_compress_stamps(host, blocks * STAMPS) != 0:
            raise RuntimeError("could not read the stamps")
        s = np.array(host[:], dtype=np.float64).reshape(blocks, STAMPS)
        d = np.diff(s, axis=1) / 1e3
        steps = np.diff(np.unique(s))
        step_us = float(steps.min()) / 1e3 if steps.size else 0.0
        total = float(s[:, -1].max() - s[:, 0].min()) / 1e3
        rows = {name: {"median_us": float(np.median(d[:, i])),
                       "max_us": float(d[:, i].max())}
                for i, name in enumerate(INTERVALS)}
        print(f"{label}: first stamp to last {total:.2f} us "
              f"(timestamp step {step_us:.3f} us)")
        for name, v in rows.items():
            print(f"  {name:48s} median {v['median_us']:6.2f}  "
                  f"max {v['max_us']:6.2f}")
        record[label] = {"total_us": total, "step_us": step_us,
                         "intervals": rows}
    print("PROBE " + json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
