"""The chunked scalar-decay linear scan of the SSD (Mamba-2) and mLSTM
mixers: ``h_t = exp(log_a_t)·h_{t−1} + k_t v_tᵀ``, ``y_t = q_t·h_t``.

Port of ``repro/kernels/ssm_scan.py``.  The Pallas TPU kernel
(``_ssm_kernel``) becomes ``csrc/ssm_scan.cu``, CUDA C++ for Hopper written
by hand: Mamba-2's chunk-parallel SSD decomposition in three launches (chunk
states, a short state-passing pass, outputs), on the tensor cores when q, k
and v are all bf16 and in fp32 on the CUDA cores otherwise; its source note
gives the bound and the design.  This module holds, on the model's layout
q, k (B, S, H, N), v (B, S, H, P), log_a (B, S, H):

* :func:`ssm_scan_plain` — the plain PyTorch version, the chunked form of
  ``repro/models/ssm.py:chunked_linear_scan`` step for step (fp32 inside,
  one chunk of the whole sequence when ``S % chunk != 0``, y in v's dtype).
  The CPU route, the model's decode step (which carries a state) and the
  tests use it, and ``chip_smoke.py`` holds the kernel against it on the
  card.
* :func:`ssm_scan_ref` — the sequential oracle of ``repro/kernels/ref.py:
  ssm_scan_ref``, on its (BH, S, ·) layout, for the tests.
* :func:`ssm_scan_cuda` — the launch of the CUDA kernels (h0 = 0, as the TPU
  kernel), which read q, k, v and log_a in place through their strides.
* :func:`ssm_scan_bwd_plain` — the scan's backward written out in the
  chunked form (the plain version of the backward kernel): the CPU route
  under autograd, and what ``chip_smoke.py`` holds the kernel to.
* :func:`ssm_scan_bwd_cuda` — the launch of ``csrc/ssm_scan_bwd.cu``,
  hand-written CUDA C++ for Hopper (no TPU kernel: the Pallas kernel has no
  VJP; JAX trains through its jnp chunked form): every product on the
  tensor cores (wgmma) with fp32's accuracy, its fp32 operands split into
  three bf16 terms, on the route :func:`bwd_route` picks from the dtypes;
  it recomputes the chunks' starting states in fp32, forms each chunk's
  gated dY·Vᵀ and Q·Kᵀ tiles once, and writes no atomics.

The public wrapper (and the launch counters) is ``ops.ssm_scan``; its
gradient goes through ``ops._SsmScanFn``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)
MAX_BH = 65535                  # B*H rides on the grid's z dimension
CHUNK = 64                      # the kernels' chunk length (csrc SC_L)
MAX_S = 65535 * CHUNK           # the chunks ride on the grid's y dimension


def workspace_numel(B: int, H: int, S: int, N: int, P: int) -> int:
    """fp32 elements of the kernels' workspace: an (N, P) state for each
    (b, h, chunk of CHUNK steps), its rows padded to a multiple of 4
    elements (16 bytes), then the B·H·chunks chunk totals.  The launcher
    refuses a smaller buffer."""
    return B * H * (-(-S // CHUNK)) * (N * (-(-P // 4) * 4) + 1)


# the backward's routes, by the inputs' dtypes alone (bwd_route)
BWD_ROUTES = ("bf16", "mixed")


def bwd_route(q_dtype: torch.dtype, k_dtype: torch.dtype,
              v_dtype: torch.dtype) -> str:
    """The backward kernel's route: ``bf16`` when q, k and v are all bf16
    (every product one or three bf16 passes on the tensor cores), else
    ``mixed`` (an fp32 operand on both sides of a product takes six)."""
    return ("bf16" if q_dtype == k_dtype == v_dtype == torch.bfloat16
            else "mixed")


def bwd_resident(q_dtype: torch.dtype, k_dtype: torch.dtype,
                 v_dtype: torch.dtype, N: int, P: int) -> bool:
    """Whether the backward runs its chunk-resident design (a block per
    (b, h, chunk) that copies the chunk's dy and v once, 16 bytes a copy):
    the ``bf16`` route at N <= 16 and P <= 448 a multiple of 8, hymba's
    heads; dy's and v's (batch, seq, head) rows must then start at 16-byte
    aligned addresses.  Every other call runs the tiled design."""
    return (bwd_route(q_dtype, k_dtype, v_dtype) == "bf16" and N <= 16
            and P <= 448 and P % 8 == 0)


def bwd_n_tile(N: int) -> int:
    """The width of the backward's tiles along the state's N: 16 for N <=
    16 (hymba's heads), else 64."""
    return 16 if N <= 16 else 64


def bwd_workspace_numel(B: int, H: int, S: int, N: int, P: int) -> int:
    """fp32 elements of the backward kernels' workspace
    (``csrc/ssm_scan_bwd.cu``): a state gradient and a starting state (N, P)
    for each (b, h, chunk of CHUNK steps), the chunk totals, then each
    chunk's parts of its boundary product (one for every 256 state
    elements), its parts of q·dq and of k·dk (CHUNK steps for every N-tile
    of ``bwd_n_tile(N)``), then its gated (CHUNK, CHUNK) tiles of dY·Vᵀ and
    Q·Kᵀ."""
    nc = -(-S // CHUNK)
    return B * H * nc * (2 * N * P + 1 + -(-N * P // 256)
                         + 2 * -(-N // bwd_n_tile(N)) * CHUNK
                         + 2 * CHUNK * CHUNK)


def ssm_scan_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_a: torch.Tensor, chunk: int,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: (B,S,H,N); v: (B,S,H,P); log_a: (B,S,H) (<= 0); h0: (B,H,N,P)
    or None for zeros -> (y (B,S,H,P) in v's dtype, h_final (B,H,N,P)
    fp32)."""
    B, S, H, N = q.shape
    P = v.shape[-1]
    L = min(chunk, S)
    if S % L:
        L = S
    nc = S // L
    f32 = torch.float32
    qf = q.to(f32).reshape(B, nc, L, H, N)
    kf = k.to(f32).reshape(B, nc, L, H, N)
    vf = v.to(f32).reshape(B, nc, L, H, P)
    la = log_a.to(f32).reshape(B, nc, L, H)
    h = (torch.zeros((B, H, N, P), dtype=f32, device=q.device) if h0 is None
         else h0.to(f32))
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    ys = []
    for c in range(nc):
        qc, kc, vc, lac = qf[:, c], kf[:, c], vf[:, c], la[:, c]
        cum = torch.cumsum(lac, dim=1)            # inclusive log decay
        total = cum[:, -1]                        # (B,H)
        # intra-chunk: M[t,s] = (q_t . k_s) * exp(cum_t - cum_s), s <= t
        scores = torch.einsum("bthn,bshn->bhts", qc, kc)
        decay = cum[:, :, None, :] - cum[:, None, :, :]        # (B,t,s,H)
        gate = torch.where(mask[None, :, :, None], torch.exp(decay),
                           torch.zeros((), dtype=f32, device=q.device))
        M = scores * gate.permute(0, 3, 1, 2)                  # (B,H,t,s)
        y_intra = torch.einsum("bhts,bshp->bthp", M, vc)
        # inter-chunk: y_t += exp(cum_t) * q_t @ h_prev
        qdec = qc * torch.exp(cum)[..., None]
        y_inter = torch.einsum("bthn,bhnp->bthp", qdec, h)
        # next state: h = exp(total) h + sum_s exp(total - cum_s) k_s v_s^T
        kdec = kc * torch.exp(total[:, None] - cum)[..., None]
        h = torch.exp(total)[..., None, None] * h + \
            torch.einsum("bshn,bshp->bhnp", kdec, vc)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B, S, H, P)
    return y.to(v.dtype), h


def ssm_scan_bwd_plain(dy: torch.Tensor, dh: Optional[torch.Tensor],
                       q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       log_a: torch.Tensor, chunk: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """The chunked backward of :func:`ssm_scan_plain` from h0 = 0, written
    out: dy (B,S,H,P) and dh (B,H,N,P) (None: h_final unused) -> (dq, dk,
    dv in the inputs' dtypes, dlog_a (B,S,H) fp32).

    fp32 inside (fp64 inside, and dlog_a fp64, when q is fp64: an exact
    reference for the kernel, whose error alone ``chip_smoke.py`` 14(a)
    holds to its bounds), chunked as the forward (one chunk of the whole sequence
    when ``S % chunk != 0``).  With cum the in-chunk inclusive prefix of
    log_a, T_c its total, h_in(c) chunk c's starting state and G(c) the
    gradient of h_in(c) (G(nc) = dh):

    * G(c) = exp(T_c)·G(c+1) + Σ_t exp(cum_t)·q_t dy_tᵀ, last chunk first;
    * dq_t = Σ_{s≤t} (dy_t·v_s)·e^{cum_t−cum_s}·k_s + e^{cum_t}·h_in(c) dy_t;
      dk_s and dv_s are the transposed intra terms plus e^{T_c−cum_s}·G(c+1)
      with v_s, or with k_s;
    * dlog_a_t = Σ_{t'≥t in c} (q·dq − k·dk)_{t'} + ⟨G(c+1), h_in(c+1)⟩
      (h_in(nc) = h_final): the reverse prefix of the whole sequence, cut at
      the chunk's end, where the rest of it is that state product; 0 at
      t = 0, a_0·⟨G_0, h0⟩ with h0 = 0, where the prefix would leave the
      rounding of its cancelling terms."""
    B, S, H, N = q.shape
    P = v.shape[-1]
    L = min(chunk, S)
    if S % L:
        L = S
    nc = S // L
    acc = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(acc).reshape(B, nc, L, H, N)
    kf = k.to(acc).reshape(B, nc, L, H, N)
    vf = v.to(acc).reshape(B, nc, L, H, P)
    dyf = dy.to(acc).reshape(B, nc, L, H, P)
    cum = torch.cumsum(log_a.to(acc).reshape(B, nc, L, H), dim=2)
    total = cum[:, :, -1]                                   # (B,nc,H)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    zero = torch.zeros((), dtype=acc, device=q.device)
    # the chunks' starting states, as the forward computes them
    h = torch.zeros((B, H, N, P), dtype=acc, device=q.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        kdec = kf[:, c] * torch.exp(total[:, c, None] - cum[:, c])[..., None]
        h = torch.exp(total[:, c])[..., None, None] * h + \
            torch.einsum("bshn,bshp->bhnp", kdec, vf[:, c])
    h_in.append(h)
    G = (torch.zeros((B, H, N, P), dtype=acc, device=q.device) if dh is None
         else dh.to(acc))
    dq, dk, dv, dla = [None] * nc, [None] * nc, [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        qc, kc, vc, dyc, cc = qf[:, c], kf[:, c], vf[:, c], dyf[:, c], cum[:, c]
        decay = cc[:, :, None, :] - cc[:, None, :, :]            # (B,t,s,H)
        gate = torch.where(mask[None, :, :, None], torch.exp(decay),
                           zero).permute(0, 3, 1, 2)             # (B,H,t,s)
        D = torch.einsum("bthp,bshp->bhts", dyc, vc) * gate
        Sc = torch.einsum("bthn,bshn->bhts", qc, kc) * gate
        ecum = torch.exp(cc)[..., None]                          # (B,L,H,1)
        erev = torch.exp(total[:, c, None] - cc)[..., None]
        dq[c] = torch.einsum("bhts,bshn->bthn", D, kc) + \
            ecum * torch.einsum("bthp,bhnp->bthn", dyc, h_in[c])
        dk[c] = torch.einsum("bhts,bthn->bshn", D, qc) + \
            erev * torch.einsum("bshp,bhnp->bshn", vc, G)
        dv[c] = torch.einsum("bhts,bthp->bshp", Sc, dyc) + \
            erev * torch.einsum("bshn,bhnp->bshp", kc, G)
        x = (qc * dq[c]).sum(-1) - (kc * dk[c]).sum(-1)          # (B,L,H)
        tail = torch.einsum("bhnp,bhnp->bh", G, h_in[c + 1])
        dla[c] = torch.flip(torch.cumsum(torch.flip(x, [1]), 1), [1]) + \
            tail[:, None]
        G = torch.exp(total[:, c])[..., None, None] * G + \
            torch.einsum("bthn,bthp->bhnp", qc * ecum, dyc)
    dla[0][:, 0] = 0.0

    def whole(parts, dtype):
        return torch.stack(parts, dim=1).reshape(
            (B, S) + tuple(parts[0].shape[2:])).to(dtype)

    return (whole(dq, q.dtype), whole(dk, k.dtype), whole(dv, v.dtype),
            whole(dla, acc))


def ssm_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_a: torch.Tensor, h0: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential recurrence.  q, k: (BH, S, N); v: (BH, S, P); log_a:
    (BH, S); h0: (BH, N, P) -> (y (BH, S, P) in v's dtype, h_final)."""
    f32 = torch.float32
    h = h0.to(f32)
    ys = []
    for t in range(q.shape[1]):
        a = torch.exp(log_a[:, t].to(f32))
        h = a[:, None, None] * h + \
            k[:, t, :, None].to(f32) * v[:, t, None, :].to(f32)
        ys.append(torch.einsum("bn,bnp->bp", q[:, t].to(f32), h))
    return torch.stack(ys, dim=1).to(v.dtype), h


_lib = None
_bwd_lib = None


def _launcher():
    global _lib
    if _lib is None:
        fn = _build.load("ssm_scan").ssm_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def _bwd_launcher():
    global _bwd_lib
    if _bwd_lib is None:
        fn = _build.load("ssm_scan_bwd").ssm_scan_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong]
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_lib = fn
    return _bwd_lib


def _code(dtype: torch.dtype) -> int:
    return 0 if dtype == torch.float32 else 1


def ssm_scan_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_a: torch.Tensor, y: torch.Tensor, h: torch.Tensor,
                  ws: torch.Tensor) -> None:
    """Launch the three kernels on the current stream, writing ``y`` (B, S,
    H, P) and ``h`` (B, H, N, P) fp32, both contiguous, through the fp32
    workspace ``ws`` (``workspace_numel`` elements).  The caller has checked
    devices, dtypes, shapes and unit inner strides (``ops._check_ssm``);
    raises if a launch fails."""
    B, S, H, N = q.shape
    P = v.shape[-1]
    strides = [t.stride(a) for t in (q, k, v, log_a, y) for a in (0, 1, 2)]
    arr = (ctypes.c_longlong * 15)(*strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         log_a.data_ptr(), y.data_ptr(), h.data_ptr(),
                         ws.data_ptr(), ws.numel(), arr, B, S, H, N, P,
                         _code(q.dtype), _code(k.dtype), _code(v.dtype),
                         stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan launch failed: error {rc} (q "
                           f"{tuple(q.shape)} {q.dtype}, v {tuple(v.shape)} "
                           f"{v.dtype})")


def ssm_scan_bwd_cuda(dy: torch.Tensor, dh: Optional[torch.Tensor],
                      q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_a: torch.Tensor, dq: torch.Tensor,
                      dk: torch.Tensor, dv: torch.Tensor, dla: torch.Tensor,
                      bws: torch.Tensor) -> str:
    """Launch the backward's four kernels on the current stream: dy (B, S,
    H, P) in v's dtype with a unit inner stride (dy's and v's rows 16-byte
    aligned where :func:`bwd_resident` holds), dh (B, H, N, P) fp32
    contiguous or None; writes the contiguous ``dq``, ``dk``, ``dv`` (the
    inputs' dtypes) and ``dla`` (fp32) through the fp32 workspace ``bws``
    (``bwd_workspace_numel`` elements).  Returns the route
    (:func:`bwd_route`).  The caller has checked devices, dtypes and shapes
    (``ops._ssm_bwd``); raises if a launch fails."""
    B, S, H, N = q.shape
    P = v.shape[-1]
    strides = [t.stride(a) for t in (q, k, v, log_a, dy) for a in (0, 1, 2)]
    arr = (ctypes.c_longlong * 15)(*strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _bwd_launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(),
            dy.data_ptr(), None if dh is None else dh.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dla.data_ptr(),
            bws.data_ptr(), bws.numel(), arr, B, S, H, N, P, _code(q.dtype),
            _code(k.dtype), _code(v.dtype), stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan backward launch failed: error {rc} (q "
                           f"{tuple(q.shape)} {q.dtype}, v {tuple(v.shape)} "
                           f"{v.dtype})")
    return bwd_route(q.dtype, k.dtype, v.dtype)
