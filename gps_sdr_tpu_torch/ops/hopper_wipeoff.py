"""Mix + code-wipeoff kernels of the K-block tracking heavy stage.

Two hand-written CUDA kernels for sm_90a, one per Pallas kernel of
gps_sdr_tpu/ops/pallas_kernels.py, as the JAX package keeps both
formulations in one module:
  * mix_wipeoff (csrc/wipeoff.cu) replaces _mxu_wipeoff_kernel (called
    through mix_wipeoff_mxu; cfg.use_mxu_wipeoff=True).  It reads a
    complex64 chunk [T, ngps];
  * mix_wipeoff_vpu (csrc/wipeoff_vpu.cu) replaces _mix_wipeoff_kernel
    (called through mix_wipeoff; cfg.use_mxu_wipeoff=False).  It reads
    the grouped planar chunk f32[T, 2, n_cyc, cs], the layout the device
    scenario synthesis produces.
Both return the same results, so heavy_stage is shared downstream.

What they compute, per channel c and block b of K-block step `step`:
  * the block mixed with the frozen NCO, factorized as
    ang(q, i) = base_b + s*(i+1) + s*cs*q with base_b = phase + snp*b
    and snp = (s*ngps) mod 2*pi (q = code period, i = sample in period);
  * the mean of the corr_avg center code periods, complex64 [K, C, cs];
  * the code wipeoff with the C/A code rolled by the block's predicted
    delay w (out[i] = code[(i - w) mod cs], np.roll semantics) and the
    head mask i < w: head sum lo[0], complex64 [C, K], and per-ms
    segment sums seg[q] = hi[q] + lo[q+1] (the last has no following
    head), complex64 [C, K, n_cyc].

What bounds them on the H100: bytes.  At the product shapes (C=11, K=8,
n_cyc=32, cs=2048) a step reads 8 blocks of 512 KB and writes 1.4 MB of
center periods; the arithmetic is ~20 flops per sample and channel
(~0.11 GFLOP a step), so the bound is ~1.7 us either way.  At the
16.384 MS/s multipath mode (cs=16384, n_cyc=8) a step reads 8.4 MB and
writes 11.5 MB: ~6 us.  Both kernels are block-stationary, as the TPU
kernels are: a CTA stages a [n_cyc, tile] slab of a block in shared
memory once and serves every channel from it, so each block leaves
device memory once; and both are one launch: the CTAs of a block form a
thread-block cluster of min(n_tiles, 16) CTAs over the n_tiles column
tiles, each of which takes n_tiles/16 tiles in a row once cs passes
2048; a CTA adds its tiles' shares of head and seg in tile order, and
the cluster adds the CTAs' shares in a fixed order through distributed
shared memory (no second kernel, no global scratch, no float atomics).
A tile has 128 columns on the 128-column grid.  Off it, mix_wipeoff's
tiles are wider where that saves a rank a second tile in a row (16 of
152 columns at 2.4 MS/s, cs 2400; csrc/wipeoff.cu tile_width), and
mix_wipeoff_vpu's stay 128 (19 at cs 2400, three ranks taking two).
There the last tile is partial: its columns past cs are not staged
(zero in shared memory), weigh zero and write no center sample; a cs
that is a multiple of 128 runs neither the wider tiles nor a mask.  A
CTA builds the tables of at most 16 channels at once and takes more in
groups, so up to 32 channels a stream fit its registers and shared
memory.
  * mix_wipeoff takes the TPU kernel's MXU factorization: the wipeoff
    sums are one contraction of the slab's re/im rows against the
    channels' weight columns, on the tensor cores (mma.sync TF32 in the
    3xTF32 split); the center mean runs in f32 on CUDA cores.
    _mix_wipeoff_mxu_math mirrors that form on the CPU, input rounding
    included.
  * mix_wipeoff_vpu stays in f32 on CUDA cores.  What held its first
    version back was latency, not arithmetic (a serial channel loop with
    three barriers and a round of dependent global loads per channel),
    so the kernel builds the tables of all channels at once while the
    slab copy is in flight (one code gather, one sincosf per (channel,
    column), weights code * exp(-i (base_b + s (i+1)))), then runs a
    main loop without barriers or global loads in which a thread holds
    a few periods' columns in registers and serves every channel,
    rotating each period's sums once by exp(-i s cs q), while helper
    warps take the center mean beside it.  _mix_wipeoff_vpu_math mirrors
    that order of arithmetic on the CPU.

The stream axis (the serving path, runtime/serving.py): every argument
and result may carry the channels of S streams on one flattened S*C
channel axis, stream after stream, with a chunk shared by all streams
([T, ...], as replicas of one capture read it) or one chunk a stream
([S, T, ...], independent front ends).  The kernels take S as the z
extent of their grid, as Pallas's vmap rule gives the TPU kernels a
stream axis, so a K-step is one launch whatever S is; a shared chunk is
read by every stream's CTAs (from L2 after the first: 8 blocks of 512 KB
a step at the product, against 50 MB of L2).  A launch over S streams
gives the bits of S single-stream launches.

The plain PyTorch versions below compute the same quantities with the
same arithmetic; a CPU tensor runs them, a CUDA tensor launches the
kernel (or raises).
"""

from __future__ import annotations

import torch

from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.ops import _build, dsp

# what both kernels (csrc/wipeoff.cu, csrc/wipeoff_vpu.cu) take: cs a
# multiple of CS_STEP samples (a period's row of complex64 or of planar
# f32 then starts on a 16-byte boundary, which cp.async staging needs)
# from one column tile (kTile, kMinCs) up to kMaxCs, the 16.384 MS/s
# mode; n_cyc in N_CYC; corr_avg up to the center periods held in
# registers (kMaxCa); up to kMaxCh channels a stream (two groups of 16)
TILE, CS_STEP, MAX_CS, MAX_CA, MAX_CH = 128, 4, 16384, 16, 32
N_CYC = (8, 16, 32, 64)


def partial_tile(cs: int) -> bool:
    """Whether a code period of cs samples ends in a partial column tile
    (cs off the 128-column grid), which the kernels mask."""
    return cs % TILE != 0


def _mix_wipeoff_math(cfg: ReceiverConfig, k: int, s: torch.Tensor,
                      snp: torch.Tensor, phase: torch.Tensor,
                      wipe: torch.Tensor, xr: torch.Tensor, xi: torch.Tensor,
                      codes: torch.Tensor):
    """The arithmetic of both kernels on the K blocks' re/im planes
    xr, xi f32[K, n_cyc, cs]."""
    from gps_sdr_tpu_torch.ops.tracking import _segment_sums_rolled

    cs, n_cyc, ca = cfg.code_samples, cfg.n_cyc, cfg.corr_avg
    n_ch = s.shape[0]
    dev = xr.device
    first = (n_cyc - ca) // 2
    col = torch.arange(cs, dtype=torch.float32, device=dev)
    row = torch.arange(n_cyc, dtype=torch.float32, device=dev)
    base = phase[:, None] + snp[:, None] * torch.arange(
        k, dtype=torch.float32, device=dev)                   # [C, K]
    ang_r = base[..., None] + s[:, None, None] * (col + 1.0)  # [C, K, cs]
    ang_q = (s * cs)[:, None] * row                           # [C, n_cyc]
    cr, sr = torch.cos(ang_r)[:, :, None], torch.sin(ang_r)[:, :, None]
    cq, sq = torch.cos(ang_q)[:, None, :, None], \
        torch.sin(ang_q)[:, None, :, None]
    osc_re = cq * cr - sq * sr                                # [C,K,n,cs]
    osc_im = sq * cr + cq * sr
    xr, xi = xr[None], xi[None]
    mixed = torch.complex(xr * osc_re + xi * osc_im,
                          xi * osc_re - xr * osc_im)
    center = mixed[:, :, first:first + ca].mean(dim=2)        # [C, K, cs]
    rolled = dsp.roll_code(codes[:, None, :], wipe)           # [C, K, cs]
    head, seg = _segment_sums_rolled(
        mixed.reshape(n_ch, k, n_cyc * cs), rolled, wipe, cfg)
    return center.transpose(0, 1).contiguous(), head, seg


def _stream_chunks(chunk: torch.Tensor, ndim: int, n_streams: int,
                   name: str) -> bool:
    """Whether `chunk` holds one chunk a stream ([S, T, ...], ndim + 1
    axes) rather than one chunk every stream reads ([T, ...], ndim
    axes); raises on anything else."""
    if n_streams < 1:
        raise ValueError(f"{name}: n_streams must be >= 1, got {n_streams}")
    if chunk.ndim == ndim:
        return False
    if chunk.ndim == ndim + 1 and chunk.shape[0] == n_streams:
        return True
    raise ValueError(f"{name}: chunk must be [T, ...] (shared) or "
                     f"[{n_streams}, T, ...] (one a stream), got "
                     f"{tuple(chunk.shape)}")


def _over_streams(one, ndim: int, name: str, cfg: ReceiverConfig, k: int,
                  s, snp, phase, wipe, chunk, step: int, codes,
                  n_streams: int):
    """The single-stream plain version `one` run stream by stream over
    the flattened S*C channel axis, its results joined as the kernels
    lay them out (center [K, S*C, cs], head [S*C, K], seg [S*C, K,
    n_cyc])."""
    per_stream = _stream_chunks(chunk, ndim, n_streams, name)
    if n_streams == 1 and not per_stream:
        return one(cfg, k, s, snp, phase, wipe, chunk, step, codes)
    c = s.shape[0] // n_streams
    parts = []
    for z in range(n_streams):
        ch = slice(z * c, (z + 1) * c)
        parts.append(one(cfg, k, s[ch], snp[ch], phase[ch], wipe[ch],
                         chunk[z] if per_stream else chunk, step, codes[ch]))
    center, head, seg = zip(*parts)
    return torch.cat(center, dim=1), torch.cat(head), torch.cat(seg)


def _mix_wipeoff_one(cfg, k, s, snp, phase, wipe, chunk, step, codes):
    blocks = chunk[step * k:(step + 1) * k].reshape(
        k, cfg.n_cyc, cfg.code_samples)
    return _mix_wipeoff_math(cfg, k, s, snp, phase, wipe, blocks.real,
                             blocks.imag, codes)


def mix_wipeoff_plain(cfg: ReceiverConfig, k: int, s: torch.Tensor,
                      snp: torch.Tensor, phase: torch.Tensor,
                      wipe: torch.Tensor, chunk: torch.Tensor, step: int,
                      codes: torch.Tensor, n_streams: int = 1):
    """Plain PyTorch version of the csrc/wipeoff.cu kernel (same
    arguments and results as mix_wipeoff), stream by stream."""
    return _over_streams(_mix_wipeoff_one, 2, "wipeoff", cfg, k, s, snp,
                         phase, wipe, chunk, step, codes, n_streams)


def _tf32(x: torch.Tensor, truncate: bool = False) -> torch.Tensor:
    """f32 cut to TF32 (10 mantissa bits): rounded to nearest with ties
    away from zero, as cvt.rna.tf32.f32 rounds, or with truncate=True
    truncated, as the tensor core reads an f32 operand."""
    bits = x.contiguous().view(torch.int32)
    if not truncate:
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def _mix_wipeoff_mxu_math(cfg: ReceiverConfig, k: int, s: torch.Tensor,
                          snp: torch.Tensor, phase: torch.Tensor,
                          wipe: torch.Tensor, xr: torch.Tensor,
                          xi: torch.Tensor, codes: torch.Tensor,
                          rounding: str = "3xtf32"):
    """CPU mirror of the csrc/wipeoff.cu contraction form, for the tests
    (the main path never calls it).  Arguments and results as
    _mix_wipeoff_math.  The wipeoff sums contract the raw re/im planes
    against the weight columns code*cos(s(i+1)), code*sin(s(i+1)) and
    their head-masked variants, with the tensor cores' input rounding:
    "f32" (none), "tf32" (single pass) or "3xtf32", the kernel's: hi
    rounded to TF32, lo = x - hi read as TF32 (truncated), and lo*hi +
    hi*lo + hi*hi; then the per-period and per-block rotations.
    The center mean is f32, as the kernel takes it on CUDA cores."""
    cs, n_cyc, ca = cfg.code_samples, cfg.n_cyc, cfg.corr_avg
    dev, f32 = xr.device, torch.float32
    first = (n_cyc - ca) // 2
    col = torch.arange(cs, dtype=f32, device=dev)
    ang_i = s[:, None] * (col + 1.0)                           # [C, cs]
    cph, sph = torch.cos(ang_i), torch.sin(ang_i)
    ang_q = (s * cs)[:, None] * torch.arange(n_cyc, dtype=f32, device=dev)
    cq, sq = torch.cos(ang_q)[:, None], torch.sin(ang_q)[:, None]
    base = phase[:, None] + snp[:, None] * torch.arange(
        k, dtype=f32, device=dev)                              # [C, K]
    cb, sb = torch.cos(base)[..., None], torch.sin(base)[..., None]

    rolled = dsp.roll_code(codes[:, None, :], wipe)            # [C, K, cs]
    in_head = (col < wipe[..., None]).to(f32)
    w1, w2 = rolled * cph[:, None], rolled * sph[:, None]
    wts = torch.stack([w1, w2, w1 * in_head, w2 * in_head], dim=2)
    x = torch.stack([xr, xi], dim=1)                     # [K, 2, n_cyc, cs]

    def contract(xa, wa):          # [C, K, plane, q, weight column]
        return torch.einsum("bpqi,cbji->cbpqj", xa, wa)

    if rounding == "f32":
        acc = contract(x, wts)
    elif rounding == "tf32":
        acc = contract(_tf32(x), _tf32(wts))
    elif rounding == "3xtf32":
        xh, wh = _tf32(x), _tf32(wts)
        xl, wl = _tf32(x - xh, True), _tf32(wts - wh, True)
        acc = contract(xl, wh) + contract(xh, wl) + contract(xh, wh)
    else:
        raise ValueError(f"rounding {rounding!r}: f32, tf32 or 3xtf32")

    def rotated(j):                # sum over i of mixed * code (* mask)
        e = acc[:, :, 0, :, j] + acc[:, :, 1, :, j + 1]
        f = acc[:, :, 1, :, j] - acc[:, :, 0, :, j + 1]
        xq, yq = cq * e + sq * f, cq * f - sq * e
        return torch.complex(cb * xq + sb * yq, cb * yq - sb * xq)

    full, lo = rotated(0), rotated(2)                      # [C, K, n_cyc]
    seg = (full - lo) + torch.cat([lo[..., 1:],
                                   torch.zeros_like(lo[..., :1])], dim=-1)

    xc = x[:, :, first:first + ca][None]                # [1, K, 2, ca, cs]
    cqc, sqc = cq[:, :, first:first + ca, None], sq[:, :, first:first + ca,
                                                    None]
    pr = (xc[:, :, 0] * cqc + xc[:, :, 1] * sqc).sum(dim=2)    # [C, K, cs]
    pi = (xc[:, :, 1] * cqc - xc[:, :, 0] * sqc).sum(dim=2)
    ur = pr * cph[:, None] + pi * sph[:, None]
    ui = pi * cph[:, None] - pr * sph[:, None]
    center = torch.complex(cb * ur + sb * ui, cb * ui - sb * ur) / ca
    return center.transpose(0, 1).contiguous(), lo[..., 0], seg


def _mix_wipeoff_vpu_math(cfg: ReceiverConfig, k: int, s: torch.Tensor,
                          snp: torch.Tensor, phase: torch.Tensor,
                          wipe: torch.Tensor, xr: torch.Tensor,
                          xi: torch.Tensor, codes: torch.Tensor):
    """CPU mirror of the csrc/wipeoff_vpu.cu order of arithmetic, for the
    tests (the main path never calls it).  Arguments and results as
    _mix_wipeoff_math.  All in f32: the raw re/im planes are summed over
    the columns against the weights code * (cos, sin)(base_b + s(i+1))
    (the head sums over the columns i < w only), each period's sums are
    then rotated once by exp(-i s cs q); the center periods are summed
    against exp(-i s cs q) and rotated once per column."""
    cs, n_cyc, ca = cfg.code_samples, cfg.n_cyc, cfg.corr_avg
    dev, f32 = xr.device, torch.float32
    first = (n_cyc - ca) // 2
    col = torch.arange(cs, dtype=f32, device=dev)
    base = phase[:, None] + snp[:, None] * torch.arange(
        k, dtype=f32, device=dev)                              # [C, K]
    ang_r = base[..., None] + s[:, None, None] * (col + 1.0)   # [C, K, cs]
    cr, sr = torch.cos(ang_r), torch.sin(ang_r)
    ang_q = (s * cs)[:, None] * torch.arange(n_cyc, dtype=f32, device=dev)
    cq, sq = torch.cos(ang_q)[:, None], torch.sin(ang_q)[:, None]  # [C,1,n]

    rolled = dsp.roll_code(codes[:, None, :], wipe)            # [C, K, cs]
    wr, wi = rolled * cr, rolled * sr
    in_head = (col < wipe[..., None]).to(f32)

    def sums(ar, ai):              # sum over i of x * (ar - i ai)
        re = torch.einsum("bqi,cbi->cbq", xr, ar) \
            + torch.einsum("bqi,cbi->cbq", xi, ai)
        im = torch.einsum("bqi,cbi->cbq", xi, ar) \
            - torch.einsum("bqi,cbi->cbq", xr, ai)
        return re, im

    fr, fi = sums(wr, wi)                                  # [C, K, n_cyc]
    lr, li = sums(wr * in_head, wi * in_head)
    hr, hi = fr - lr, fi - li
    hi_rot = torch.complex(cq * hr + sq * hi, cq * hi - sq * hr)
    lo = torch.complex(cq * lr + sq * li, cq * li - sq * lr)
    seg = hi_rot + torch.cat([lo[..., 1:], torch.zeros_like(lo[..., :1])],
                             dim=-1)

    xcr, xci = xr[None, :, first:first + ca], xi[None, :, first:first + ca]
    cqc = cq[:, :, first:first + ca, None]                  # [C, 1, ca, 1]
    sqc = sq[:, :, first:first + ca, None]
    pr = (xcr * cqc + xci * sqc).sum(dim=2)                    # [C, K, cs]
    pi = (xci * cqc - xcr * sqc).sum(dim=2)
    center = torch.complex(cr * pr + sr * pi, cr * pi - sr * pr) * (1.0 / ca)
    return center.transpose(0, 1).contiguous(), lo[..., 0], seg


def _mix_wipeoff_vpu_one(cfg, k, s, snp, phase, wipe, chunk, step, codes):
    blocks = chunk[step * k:(step + 1) * k]                # [K, 2, n, cs]
    return _mix_wipeoff_math(cfg, k, s, snp, phase, wipe, blocks[:, 0],
                             blocks[:, 1], codes)


def mix_wipeoff_vpu_plain(cfg: ReceiverConfig, k: int, s: torch.Tensor,
                          snp: torch.Tensor, phase: torch.Tensor,
                          wipe: torch.Tensor, chunk: torch.Tensor,
                          step: int, codes: torch.Tensor,
                          n_streams: int = 1):
    """Plain PyTorch version of the csrc/wipeoff_vpu.cu kernel (same
    arguments and results as mix_wipeoff_vpu), stream by stream."""
    return _over_streams(_mix_wipeoff_vpu_one, 4, "wipeoff_vpu", cfg, k, s,
                         snp, phase, wipe, chunk, step, codes, n_streams)


def _check(t: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != dev or not t.is_contiguous():
        raise ValueError(
            f"wipeoff kernel: {name} must be a contiguous {dtype} "
            f"{tuple(shape)} on {dev}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def _launch(name: str, args_type, cfg: ReceiverConfig, k: int, s, snp,
            phase, wipe, chunk, step: int, codes, n_streams: int,
            per_stream: bool, block: tuple):
    """Check the arguments of either wipeoff kernel (chunk blocks of
    `block` = (dtype, shape)), allocate its results and launch it over
    n_streams streams: grid z = S, each stream's chunk chunk_stride
    elements after the previous one's (0 for a shared chunk)."""
    cs, n_cyc = cfg.code_samples, cfg.n_cyc
    n_all, dev = s.shape[0], chunk.device
    if n_all % n_streams:
        raise ValueError(f"{name} kernel: {n_all} channels do not split "
                         f"into {n_streams} streams")
    t = chunk.shape[1 if per_stream else 0]
    if step < 0 or (step + 1) * k > t:
        raise ValueError(f"{name} kernel: step {step} x K={k} outside "
                         f"a chunk of {t} blocks")
    lead = (n_streams, t) if per_stream else (t,)
    _check(chunk, "chunk", block[0], lead + block[1], dev)
    _check(codes, "codes", torch.float32, (n_all, cs), dev)
    for arg, v in (("s", s), ("snp", snp), ("phase", phase)):
        _check(v, arg, torch.float32, (n_all,), dev)
    _check(wipe, "wipe", torch.int32, (n_all, k), dev)
    stride = chunk[0].numel() if per_stream else 0
    center = torch.empty((k, n_all, cs), dtype=torch.complex64, device=dev)
    head = torch.empty((n_all, k), dtype=torch.complex64, device=dev)
    seg = torch.empty((n_all, k, n_cyc), dtype=torch.complex64, device=dev)
    args = args_type(
        chunk.data_ptr(), codes.data_ptr(), s.data_ptr(), snp.data_ptr(),
        phase.data_ptr(), wipe.data_ptr(), center.data_ptr(),
        head.data_ptr(), seg.data_ptr(), stride, n_all // n_streams, k, step,
        n_cyc, cs, cfg.corr_avg, n_streams)
    _build.launch(name, args, dev)
    return center, head, seg


def _limits(name: str, cfg: ReceiverConfig, n_ch: int,
            chunk_ptr: int) -> None:
    """Raise on what the wipeoff kernel `name` (both take the same) does
    not take: the configuration, the number of channels a stream, the
    address of the chunk."""
    cs, n_cyc, ca = cfg.code_samples, cfg.n_cyc, cfg.corr_avg
    if cs % CS_STEP or not TILE <= cs <= MAX_CS or n_cyc not in N_CYC \
            or not 0 < ca <= min(n_cyc, MAX_CA) or not 0 < n_ch <= MAX_CH:
        raise ValueError(
            f"{name} kernel: needs cs a multiple of {CS_STEP} from {TILE} "
            f"to {MAX_CS} (a sample rate a multiple of 4 kHz), n_cyc in "
            f"{N_CYC}, 0 < corr_avg <= min(n_cyc, {MAX_CA}) and 1 to "
            f"{MAX_CH} channels a stream; got cs={cs}, n_cyc={n_cyc}, "
            f"corr_avg={ca}, {n_ch} channels")
    if chunk_ptr % 16:
        raise ValueError(f"{name} kernel: chunk must start on a 16-byte "
                         "boundary (cp.async staging)")


def mix_wipeoff(cfg: ReceiverConfig, k: int, s: torch.Tensor,
                snp: torch.Tensor, phase: torch.Tensor, wipe: torch.Tensor,
                chunk: torch.Tensor, step: int, codes: torch.Tensor,
                n_streams: int = 1):
    """Mix + wipeoff of K-block step `step` of `chunk`, all channels of
    n_streams streams.

    s, snp, phase: f32[S*C] (rad/sample, per-block phase advance mod
    2*pi, NCO phase at the step's first sample); wipe: i32[S*C, K]
    wipeoff delays in [0, cs); chunk: complex64[T, ngps], read by every
    stream, or [S, T, ngps], one chunk a stream (whole chunks: the kernel
    reads block step*K + b itself); codes: f32[S*C, cs] unrolled.  The
    channels of stream z are z*C .. z*C + C - 1.  Returns (center
    c64[K, S*C, cs], head c64[S*C, K], seg c64[S*C, K, n_cyc]).
    """
    if chunk.device.type == "cpu":
        return mix_wipeoff_plain(cfg, k, s, snp, phase, wipe, chunk, step,
                                 codes, n_streams)
    if chunk.device.type != "cuda":
        raise ValueError(f"wipeoff kernel: no path for {chunk.device}")
    per_stream = _stream_chunks(chunk, 2, n_streams, "wipeoff kernel")
    _limits("wipeoff", cfg, s.shape[0] // n_streams, chunk.data_ptr())
    out = _launch("wipeoff", _build.WipeoffArgs, cfg, k, s, snp, phase,
                  wipe, chunk, step, codes, n_streams, per_stream,
                  (torch.complex64, (cfg.ngps,)))
    mix_wipeoff.launches += 1
    return out


mix_wipeoff.launches = 0


def mix_wipeoff_vpu(cfg: ReceiverConfig, k: int, s: torch.Tensor,
                    snp: torch.Tensor, phase: torch.Tensor,
                    wipe: torch.Tensor, chunk: torch.Tensor, step: int,
                    codes: torch.Tensor, n_streams: int = 1):
    """Mix + wipeoff of K-block step `step` of a grouped planar chunk,
    all channels of n_streams streams (csrc/wipeoff_vpu.cu).

    Arguments as mix_wipeoff, except chunk: f32[T, 2, n_cyc, cs], read by
    every stream, or [S, T, 2, n_cyc, cs], one chunk a stream (re and im
    planes of every block; the kernel reads block step*K + b itself).
    At most MAX_CH channels a stream.  Returns (center
    c64[K, S*C, cs], head c64[S*C, K], seg c64[S*C, K, n_cyc]), as
    mix_wipeoff does."""
    if chunk.device.type == "cpu":
        return mix_wipeoff_vpu_plain(cfg, k, s, snp, phase, wipe, chunk,
                                     step, codes, n_streams)
    if chunk.device.type != "cuda":
        raise ValueError(f"wipeoff_vpu kernel: no path for {chunk.device}")
    per_stream = _stream_chunks(chunk, 4, n_streams, "wipeoff_vpu kernel")
    _limits("wipeoff_vpu", cfg, s.shape[0] // n_streams, chunk.data_ptr())
    out = _launch("wipeoff_vpu", _build.WipeoffVpuArgs, cfg, k, s, snp,
                  phase, wipe, chunk, step, codes, n_streams, per_stream,
                  (torch.float32, (2, cfg.n_cyc, cfg.code_samples)))
    mix_wipeoff_vpu.launches += 1
    return out


mix_wipeoff_vpu.launches = 0
