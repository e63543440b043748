"""Where the flash attention backward's tensor-core kernel spends its time,
on a CUDA card: builds variants of ``csrc/flash_attention_bwd.cu`` and times
each through the port's wrapper, printing one JSON line that starts with
``ROLES``.

    python3 scripts/flash_bwd_roles.py

The variants, each built from this checkout's source with one edit:

* ``kernel``: the source as it is;
* ``dkdv_only``: the dQ blocks return at once (the dK/dV blocks' time);
* ``dq_only``: the dK/dV blocks return at once (the dQ blocks' time);
* ``exp2f``: the softmax's ``ex2_approx`` replaced by ``exp2f`` (what the
  range fix-up of the library call costs).

Each is timed with ``chip_smoke.Timer`` (median of 30 after an L2 flush, a
spin kernel ahead of each call; the prep kernel included) at qwen2-0.5b's
training shape (4, 1024, 14 / 2, 64), 13(c)'s folded (16, 32, 14 / 2, 64)
and hd 128 (4, 1024, 14 / 2, 128), causal, bf16.  ``kernel`` and ``exp2f``
are checked bit for bit against each other.  The variants' sources and
libraries go to ``build/kernels/roles/``.  Exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(4, 1024, 14, 2, 64), (16, 32, 14, 2, 64), (4, 1024, 14, 2, 128)]
ROLE_CALL = "    if (kv_role) bt_dkdv<NP>"


def variants(src: str) -> dict:
    out = {"kernel": src,
           "dkdv_only": src.replace(ROLE_CALL,
                                    "    if (!kv_role) return;\n" + ROLE_CALL),
           "dq_only": src.replace(ROLE_CALL,
                                  "    if (kv_role) return;\n" + ROLE_CALL)}
    tc = src.index("// bf16 on the tensor cores")
    out["exp2f"] = src[:tc] + src[tc:].replace("ex2_approx(", "exp2f(")
    for name, text in out.items():
        if name != "kernel" and text == src:
            raise RuntimeError(f"variant {name}: the edit found nothing")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_roles: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa

    csrc = _build.CSRC
    out_dir = _build.BUILD_DIR / "roles"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (csrc / "flash_attention_bwd.cu").read_text()
    for header in _build.sources("flash_attention_bwd")[1:]:
        (out_dir / header).write_bytes((csrc / header).read_bytes())
    procs = {}
    for name, text in variants(src).items():
        cu = out_dir / f"{name}.cu"           # beside the headers it includes
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    launchers = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")
                         ).flash_attention_bwd_bf16_launch
        fn.argtypes = ([ctypes.c_void_p] * 10
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        launchers[name] = fn
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    timer = cs.Timer()
    rows = []
    for B, S, H, KV, hd in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(15)
        q, k, v = cs.flash_inputs(B, S, H, KV, hd, torch.bfloat16, gen)
        do = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
        o, lse = ops._flash_fwd(q, k, v, True, 0, True)
        row, grads = {"shape": [B, S, H, KV, hd]}, {}
        for name, fn in launchers.items():
            fa._bwd_launchers["tensor_cores"] = fn
            row[name + "_ms"] = timer.ms(
                lambda: ops._flash_bwd(do, q, k, v, o, lse, True, 0))
            grads[name] = ops._flash_bwd(do, q, k, v, o, lse, True, 0)
        torch.cuda.synchronize()
        row["exp2f_same_bits"] = all(
            torch.equal(a, b) for a, b in zip(grads["kernel"],
                                              grads["exp2f"]))
        rows.append(row)
    fa._bwd_launchers.clear()
    print("ROLES " + json.dumps({"card": card, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
