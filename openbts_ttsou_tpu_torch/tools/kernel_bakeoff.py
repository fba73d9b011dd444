"""K1, the polyphase resampler, three ways at every shape the main paths
give it: the hand-written CUDA kernel, its plain PyTorch form
(`cuda_fir.polyphase_resample_plain`) and one float32 `F.conv1d` of the
same filter bank with TF32 off (a yardstick the port never calls). K7,
the threshold walk, two ways (`bake_walk`): the kernel and
`exact_walk_plain`, at `K7_SHAPES`; K8, the Viterbi decoder, two ways
(`bake_viterbi`): the kernel and `viterbi_decode_plain`, at
`K8_SHAPES`; K5, the DFE's feedback recursion, two ways
(`bake_equalize`): the kernel and `feedback_recursion_plain`, at
`K5_SHAPES` (`chip_smoke.py` phase 2 runs all three). `ptxas_usage` reads
each kernel's registers, stack and spills from the build's output.

For each shape: device ms of each path (CUDA events, the calls queued
behind a device sleep so the host's dispatch stays out), the kernel's
bound (its bytes at the HBM rate against its float32 FMAs at the
float32 rate, the larger), its share of the bound, its GB/s, the
instantiation it runs and its largest difference from the plain form.
On the CPU only the plain form and the convolution run, timed by the
wall clock.

    python -m openbts_ttsou_tpu_torch.tools.kernel_bakeoff [--reps 25]
"""

from __future__ import annotations

import re
import time

import numpy as np
import torch
import torch.nn.functional as F

from openbts_ttsou_tpu_torch.tools import common, roofline

TOOL = "kernel_bakeoff"
N_CHAN = 512
#: K1's shapes on the main paths, (rows, p, q, taps, T) on [rows, T]: the
#: uplink, its downlink stimulus, the duplex block's two calls, and a
#: shard's two calls on a (chan 2, time 2) mesh
K1_SHAPES = ((N_CHAN, 65, 96, 961, 24000), (N_CHAN, 96, 65, 651, 16250),
             (N_CHAN, 65, 96, 961, 24192), (N_CHAN, 96, 65, 651, 16380),
             (N_CHAN // 2, 65, 96, 961, 24192),
             (N_CHAN // 2, 96, 65, 651, 16380))


#: K7's shapes on the main paths, (frames, carriers) of [F, C, 8]: the
#: 13-frame block at 512 carriers and at the batched schedule's largest
K7_SHAPES = ((13, N_CHAN), (13, 4 * N_CHAN))

#: K5's shapes on the main paths, (bursts, T, ν) of [B, T]: a 13-frame
#: block of 512 carriers (the bank's call) and one frame of them (the
#: per-frame daemon's `rx_step`)
K5_SHAPES = ((13 * 8 * N_CHAN, roofline.T, roofline.NU),
             (8 * N_CHAN, roofline.T, roofline.NU))

#: K8's shapes on the main paths, (code, rows, K) of [rows, 2K]: the four
#: calls of a resident window at 512 carriers
K8_SHAPES = tuple((kind, per_chan * N_CHAN, k)
                  for kind, (per_chan, k) in roofline.VITERBI_KINDS.items())


def bound_ms(rows: int, t_in: int, p: int, q: int,
             lpf: np.ndarray) -> tuple[float, str]:
    """Least time for K1's work on an H100: `roofline.k1_work` (each
    input read once and each output written once, the float32 FMAs of
    the nonzero taps each output uses) at the data-sheet rates."""
    from openbts_ttsou_tpu_torch.tools import roofline

    return roofline.bound_ms(roofline.k1_work(rows, t_in, p, q, lpf),
                             common.HBM_BYTES_PER_S, common.FP32_FLOPS)


def library_call(x: torch.Tensor, p: int, q: int, lpf: np.ndarray):
    """One strided float32 convolution computing K1's function on x's
    real and imaginary planes (cuDNN on the card)."""
    from openbts_ttsou_tpu_torch.ops import fir

    t_in, taps = x.shape[-1], len(lpf)
    _, _, _, _, k_prime, pad_left = fir._polyphase_plan(p, q, taps)
    n_out = fir.polyphase_output_len(t_in, p, q)
    m_cycles = -(-n_out // p)
    pad_right = max(0, (m_cycles - 1) * q + k_prime - pad_left - t_in)
    bank = torch.from_numpy(fir._polyphase_filter_bank(p, q, lpf)).to(
        x.device)  # [p, 1, K']
    planes = torch.cat([x.real, x.imag])[:, None, :]
    return lambda: F.conv1d(F.pad(planes, (pad_left, pad_right)), bank,
                            stride=q)


def bake(rows: int, p: int, q: int, taps: int, t_in: int,
         gen: torch.Generator, reps: int = 25) -> dict:
    """K1 at one shape on the card: the three paths' device ms, the
    bound and the kernel's difference from the plain form."""
    from openbts_ttsou_tpu_torch.ops import cuda_fir, fir

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.randn((rows, t_in), dtype=torch.complex64, device="cuda",
                    generator=gen)
    lpf = fir.resampler_lpf(p, q, taps)

    def kernel():
        return cuda_fir.polyphase_resample_cuda(x, p, q, lpf)

    def plain():
        return cuda_fir.polyphase_resample_plain(x, p, q, lpf)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    bound, bound_by = bound_ms(rows, t_in, p, q, lpf)
    nbytes = rows * (t_in + fir.polyphase_output_len(t_in, p, q)) * 8
    ms, ahead = common.cuda_ms(kernel, reps)
    plain_ms, _ = common.cuda_ms(plain, reps)
    library_ms, library_ahead = common.cuda_ms(library_call(x, p, q, lpf),
                                               reps)
    return {"geometry": f"{p}/{q} {taps} taps [{rows}, {t_in}]",
            "instantiation": cuda_fir.instantiation(p, q, lpf),
            "shape_ok": got.shape == want.shape,
            "finite": bool(torch.isfinite(got).all()),
            "max_abs_err": float((got - want).abs().max()),
            "max_abs_plain": float(want.abs().max()),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "bound_share": bound / ms, "gbytes_per_s": nbytes / ms / 1e6,
            "host_queue_share": {"kernel": ahead, "library": library_ahead}}


def walk_inputs(frames: int, carriers: int, gen: torch.Generator) -> tuple:
    """Random inputs for `exact_walk` on the card: energies around the
    initial threshold squared (so the gate, hits, misses and quiet slots
    all occur), random flags, need_dfe on half the carriers, the state's
    false-detect and estimate frames within 100 frames of the block."""
    from openbts_ttsou_tpu_torch.trx import engine as eng

    dev = torch.device("cuda")
    shape = (frames, carriers, 8)

    def flags(p):
        return torch.rand(shape, generator=gen, device=dev) < p

    def near(size):
        return torch.randint(0, 100, size, generator=gen, device=dev,
                             dtype=torch.int32)

    state = eng.init_state(eng.TrxConfig(n_chan=carriers), dev)
    state = state._replace(prev_false_detect_fn=near((carriers,)),
                           chan_estimate_fn=near((carriers, 8)),
                           chan_valid=torch.rand((carriers, 8), generator=gen,
                                                 device=dev) < 0.5)
    thr2 = float(state.energy_threshold[0]) ** 2
    energy = thr2 * torch.exp(3 * torch.rand(shape, generator=gen,
                                             device=dev) - 1.5)
    fns = 100 + torch.arange(frames, dtype=torch.int32, device=dev)
    need_dfe = torch.rand(carriers, generator=gen, device=dev) < 0.5
    return (fns, flags(0.9), flags(0.8), energy, flags(0.6), flags(0.6),
            need_dfe, state)


def bake_walk(frames: int, carriers: int, gen: torch.Generator,
              reps: int = 25) -> dict:
    """K7 at [frames, carriers, 8] on the card: the kernel's and the plain
    form's device ms, the bound (`roofline.k7_work`) and the count of
    output elements that differ from the plain form's (0: bit for bit)."""
    from openbts_ttsou_tpu_torch.tools import roofline
    from openbts_ttsou_tpu_torch.trx import engine as eng

    args = walk_inputs(frames, carriers, gen)
    got, want = eng.exact_walk(*args), eng.exact_walk_plain(*args)
    torch.cuda.synchronize()
    differ = sum(int((g != w).sum()) for g, w in zip(got, want))
    bound, bound_by = roofline.bound_ms(roofline.k7_work(frames, carriers),
                                        common.HBM_BYTES_PER_S,
                                        common.FP32_FLOPS)
    ms, ahead = common.cuda_ms(lambda: eng.exact_walk(*args), reps)
    # ~3,000 launches a call: the host queues the plain form slower than
    # the card runs it, so its interval is the host's dispatch
    plain_ms, _ = common.cuda_ms(lambda: eng.exact_walk_plain(*args), 5)
    return {"geometry": f"[{frames}, {carriers}, 8]", "differ": differ,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "bound_share": bound / ms,
            "host_queue_share": ahead}


def bake_viterbi(code: str, rows: int, k: int, gen: torch.Generator,
                 reps: int = 25) -> dict:
    """K8 at [rows, 2K] on the card, on soft bits of random codewords
    (Gaussian noise, 5% erased): the kernel's and the plain form's device
    ms, the bound (`roofline.k8_work`) and the count of decoded bits that
    differ from the plain form's (0: bit for bit)."""
    from openbts_ttsou_tpu_torch.gsm import fec

    dev = torch.device("cuda")
    u = torch.randint(0, 2, (rows, k), generator=gen, device=dev,
                      dtype=torch.uint8)
    c = fec.conv_encode(u).to(torch.float32)
    soft = (c + 0.3 * torch.randn(c.shape, generator=gen, device=dev)
            ).clamp(0, 1)
    soft[torch.rand(c.shape, generator=gen, device=dev) < 0.05] = 0.5
    got, want = fec.viterbi_decode(soft), fec.viterbi_decode_plain(soft)
    torch.cuda.synchronize()
    bound, bound_by = roofline.bound_ms(roofline.k8_work(rows, k),
                                        common.HBM_BYTES_PER_S,
                                        common.FP32_FLOPS)
    ms, ahead = common.cuda_ms(lambda: fec.viterbi_decode(soft), reps)
    # ~2,500 launches a call: its interval is the host's dispatch
    plain_ms, _ = common.cuda_ms(lambda: fec.viterbi_decode_plain(soft), 3)
    return {"geometry": f"{code} [{rows}, {2 * k}]",
            "differ": int((got != want).sum()),
            "max_abs_err": int((got.int() - want.int()).abs().max()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "bound_share": bound / ms,
            "host_queue_share": ahead}


def equalize_inputs(bursts: int, t: int, nu: int,
                    gen: torch.Generator) -> tuple:
    """(pf, feedback, rot) on the card as the equalizer sees them: ±1
    symbols rotated, the feedback's interference of the symbols before
    them, complex noise of 0.4; taps of falling size."""
    from openbts_ttsou_tpu_torch.ops import gmsk

    dev = torch.device("cuda")
    rot = torch.from_numpy(gmsk.rotation(t, 1)).to(dev)

    def cnormal(shape):
        return torch.randn(shape, dtype=torch.complex64, generator=gen,
                           device=dev)

    fb = cnormal((bursts, nu)) * (0.5 ** torch.arange(
        1, nu + 1, device=dev))
    sign = torch.randint(0, 2, (bursts, t), generator=gen, device=dev) * 2 - 1
    sym = sign * rot
    pf = sym + 0.4 * cnormal((bursts, t)) * rot
    for j in range(nu):
        pf[:, j + 1:] -= fb[:, j: j + 1] * sym[:, : t - j - 1]
    return pf.contiguous(), fb.contiguous(), rot


def bake_equalize(bursts: int, t: int, nu: int, gen: torch.Generator,
                  reps: int = 25) -> dict:
    """K5 at [bursts, t], ν taps, on the card: the kernel's and the plain
    form's device ms, the kernel's bound (`roofline.k5_recursion_work`)
    and the count of soft bits that differ from the plain form's (0:
    bit for bit)."""
    from openbts_ttsou_tpu_torch.ops import cuda_dfe, dfe

    pf, fb, rot = equalize_inputs(bursts, t, nu, gen)
    got = cuda_dfe.equalize_cuda(pf, fb, rot)
    want = dfe.feedback_recursion_plain(pf, fb, rot)
    torch.cuda.synchronize()
    work = roofline.k5_recursion_work(bursts, t, nu)
    bound, bound_by = roofline.bound_ms(work, common.HBM_BYTES_PER_S,
                                        common.FP32_FLOPS)
    ms, ahead = common.cuda_ms(lambda: cuda_dfe.equalize_cuda(pf, fb, rot),
                               reps)
    # ~1,450 launches a call: its interval is the host's dispatch
    plain_ms, _ = common.cuda_ms(
        lambda: dfe.feedback_recursion_plain(pf, fb, rot), 3)
    return {"geometry": f"[{bursts}, {t}] nu {nu}",
            "differ": int((got != want).sum()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "bound_share": bound / ms,
            "gbytes_per_s": work.bytes / ms / 1e6,
            "host_queue_share": ahead}


def ptxas_usage(text: str) -> dict:
    """{entry function: {registers, stack, spill_stores, spill_loads}}
    from nvcc's `-Xptxas=-v` output (bytes, but registers)."""
    usage, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            usage[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            usage[name].update(zip(("stack", "spill_stores", "spill_loads"),
                                   map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name]["registers"] = int(m.group(1))
    return usage


def bake_cpu(rows: int, p: int, q: int, taps: int, t_in: int,
             reps: int) -> dict:
    """The plain form and the convolution on the CPU, wall ms."""
    from openbts_ttsou_tpu_torch.ops import cuda_fir, fir

    g = torch.Generator().manual_seed(1)
    x = torch.randn((rows, t_in), dtype=torch.complex64, generator=g)
    lpf = fir.resampler_lpf(p, q, taps)

    def wall(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    return {"geometry": f"{p}/{q} {taps} taps [{rows}, {t_in}]",
            "ms": None,
            "plain_wall_ms": wall(
                lambda: cuda_fir.polyphase_resample_plain(x, p, q, lpf)),
            "library_wall_ms": wall(library_call(x, p, q, lpf))}


def main(argv=None) -> dict:
    ap = common.parser(__doc__)
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--rows", type=int, default=0,
                    help="rows at every shape (default: each shape's own)")
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    shapes = [((args.rows or r), p, q, taps, t)
              for r, p, q, taps, t in K1_SHAPES]
    if dev.type == "cuda":
        gen = torch.Generator(device="cuda").manual_seed(1)
        rows = [bake(*s, gen, args.reps) for s in shapes]
    else:
        rows = [bake_cpu(*s, min(args.reps, 3)) for s in shapes]
    return common.emit({"tool": TOOL, "shapes": rows, **common.card(dev)})


if __name__ == "__main__":
    main()
