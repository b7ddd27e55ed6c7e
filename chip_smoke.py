#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card and check it.

Run from the repository root on a machine with a card and the CUDA toolkit:

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result:

1. build   - compile every CUDA kernel under brevitas_tpu_torch/csrc (one
             nvcc per source, all at once) and print the time and ptxas report.
2. card    - the card's name and power limit, as nvidia-smi reports them.
3. kernels - the GEMM kernels at the LFC shapes (M in {1, 128, 1024}, (K, N) in
             {(784, 1024), (1024, 1024), (1024, 10)}), int8_matmul and
             int4_matmul at the Llama shapes (M in {4096, 16}, the four (K, N)
             of a block and the head), int8_matmul at serve --decode's four
             shapes (M 32) and int4_matmul at ragged shapes, on
             random full-range codes, held against their plain PyTorch
             versions on the card: int8 and W4A8 bit for bit, w4a16 within
             1e-5 * sum|bf16(x)||w| * |w_scale|. Median times (CUDA events) of
             the kernel, the plain version and one library call, beside the
             least time the card could take.
4. attn    - int8_attention at (BH, T, D) = (128, 512, 64) causal and a ragged
             grouped-query shape; int4kv_decode_attention at (BH, l_half, D) =
             (256, 512, 64) with pos in {63, 0, 511, 1023}. Held to the plain
             versions code by code: probability codes differ by at most one,
             in at most 1e-4 of them; the output is exactly the PV product of
             the kernel's own codes, and within (row flips) * 128 * p_scale *
             v_scale of the plain one. Times as above; the library point is
             bf16 scaled_dot_product_attention, which is not the same function.
5. serve   - examples.serve.main at LFC's full widths (512 requests, batch
             128); int8_matmul must launch 4 times per batch plus the warm-up
             batch. One batch is compared with a CPU copy of the served model,
             which takes the plain path.
6. lfc     - LFC 4-bit (w4a16 twins) and LFC 8-bit (carried-grid int8 twins)
             calibrated, converted and served at batch 1024; 4 launches each,
             compared with CPU copies.
7. llama_prefill - the repo's Llama (vocab 2000, dim 1024, depth 6, 16 heads;
             random weights from seed 0) calibrated by one train-mode forward,
             converted, and served a causal 8 x 512 prefill: 6 int8_attention
             and 43 int8_matmul launches per forward. Each attention twin of a
             CPU copy, fed the card's input, and the logits of one sequence
             are compared with the card's.
8. llama_decode - 64 greedy decode steps at batch 16 against a 1024-position
             cache, int8 KV and int4-packed KV: 43 int8_matmul launches a
             step, and 6 int4kv_decode_attention launches a packed step. The
             first 16 steps of 2 sequences are compared with a CPU copy fed
             the same tokens.
9. llama_w4a8_prefill, llama_w4a8_decode - the same Llama with 4-bit weights
             per output channel (Int4WeightPerChannelFloat) and 8-bit
             activations: every linear packed, 43 int4_matmul launches per
             forward or step and no int8_matmul; checked as in 7 and 8.
10. serve_decode - examples.serve.main(["--decode"]) at its defaults (dim 128,
             batch 32, 128 tokens), with the int8 KV cache and with --kv-bits
             4: 13 int8_matmul launches a step, 2 int4kv_decode_attention a
             packed step. The model it timed decodes again on the card; its
             tokens equal the served ones, and its logits of all 32
             sequences over the 128 steps are checked as in 8.
11. report - one {"kernels": [...]} line; the last line is
             {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

The comparison with a CPU copy is made layer by layer, each serving layer of
the copy fed the card's input to that layer (int8 GEMM layers must match
exactly, w4a16 layers within the tolerance above, attention layers in at
least 99 % of their token rows: a probability code that flips at a .5 tie
changes its own row), and end to end on the logits (LFC: reported; Llama
and serve --decode: a copy fed the card's attention outputs must give the
card's logits bit for bit, and a free-running copy needs argmax agreement
of at least 90 % and max |diff| within 10 % of the largest logit, since a
flipped code feeds the later positions and layers).
"""

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

LFC_KN = [(784, 1024), (1024, 1024), (1024, 1024), (1024, 10)]  # LFC's linears
SHAPES_KN = [(784, 1024), (1024, 1024), (1024, 10)]
SHAPES_M = [1, 128, 1024]
SERVE_BATCH = 128   # serve phase batch: the int8 path's M
# examples.serve --decode at the JAX package's defaults; its model has depth
# 2, each block 4 + 2 linears, plus the head: the int8_matmul shapes below
SERVE_DECODE = dict(tokens=128, batch=32, dim=128)
SERVE_DECODE_BLOCKS = 2
SERVE_DECODE_KN = [(128, 128), (128, 512), (512, 128), (128, 256)]
LFC_BATCH = 1024    # lfc phase batch: the w4a16 path's M

# dense peaks from NVIDIA's data sheets: memory bytes/s, int8 op/s, bf16 flop/s
PEAKS = {
    "H100 SXM": (3.35e12, 1979e12, 989e12),
    "H100 PCIe": (2.0e12, 1513e12, 756e12),
}


def peaks_for(name: str):
    sheet = "H100 PCIe" if "PCIe" in name else "H100 SXM"
    return sheet, PEAKS[sheet]


SLEEP_CYCLES = 20_000_000  # about 10 ms of GPU clock: covers enqueueing `inner` calls


def cuda_ms(fn, reps: int = 25, inner: int = 10, device_only: bool = True) -> float:
    """Median over ``reps`` windows of ``inner`` back-to-back calls, in ms
    per call, timed with CUDA events after a warm-up (inputs stay hot in L2,
    as a served model's weights do).

    ``device_only``: the card first sleeps while the host enqueues the
    window, so the events time the device work alone, not the host's launch
    overhead. Without it the time per call includes that overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
        if device_only and enqueue_ms > 8.0:
            print(f"[kernels] warning: enqueueing took {enqueue_ms:.2f} ms, near the "
                  "sleep; this device time may include host gaps")
    return statistics.median(times)


def w4a16_tolerance(x, w_packed, w_scale):
    """1e-5 of sum |bf16(x)| |w| * |w_scale|: bf16 x int4 products are exact
    in float32, so a kernel and its plain version differ only in summation
    order."""
    from brevitas_tpu_torch.kernels import unpack_int4_rows

    xb = x.to(torch.bfloat16).to(torch.float32).abs()
    w = unpack_int4_rows(w_packed).to(torch.float32).abs()
    return 1e-5 * (xb @ w) * w_scale.abs().reshape(1, -1)


def bound(bytes_moved: float, ops: float, bw: float, peak: float):
    t_bytes, t_ops = bytes_moved / bw * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build():
    from brevitas_tpu_torch.csrc import build

    t0 = time.perf_counter()
    reports = build.build()
    print(f"[build] {len(build.SOURCES)} kernels ready in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"[build] {name}: {line.strip()}")


def phase_card() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print("[card] nvidia-smi name, power.limit:")
    print(line)
    return line


def phase_kernels(dev, peaks):
    """Per (kernel, M, K, N): correctness and times. Returns the rows."""
    from brevitas_tpu_torch.kernels import (
        int4_weight_only_matmul,
        int4_weight_only_matmul_reference,
        int8_matmul,
        int8_matmul_reference,
        unpack_int4_rows,
    )

    bw, int8_peak, bf16_peak = peaks
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    print("[kernels] kernel M K N | kernel_ms plain_ms library_ms bound_ms "
          "bound_by | max_abs_err | call_ms (device times; call_ms includes the "
          "host's launch overhead)")
    shapes = ([(m, k, n) for m in SHAPES_M for k, n in SHAPES_KN]
              + [(m, k, n) for m in LLAMA_M for k, n in LLAMA_KN]
              + [(SERVE_DECODE["batch"], k, n) for k, n in SERVE_DECODE_KN])
    for m, k, n in shapes:
        lfc = m in SHAPES_M and (k, n) in SHAPES_KN
        # int8: the serving path passes a bias and no activation
        x = torch.randint(-128, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        w = torch.randint(-128, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        xs = torch.rand((), generator=g, device=dev) * 0.05 + 1e-3
        ws = torch.rand(n, generator=g, device=dev) * 0.05 + 1e-3
        b = torch.randn(n, generator=g, device=dev)
        for act in (None, "relu"):
            got = int8_matmul(x, w, xs, ws, b, act=act)
            want = int8_matmul_reference(x, w, xs, ws, b, act=act)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"int8_matmul differs from its plain version at {(m, k, n)} "
                    f"act={act}: max {float((got - want).abs().max())}")
        err = float((got - want).abs().max())
        t_k = cuda_ms(lambda: int8_matmul(x, w, xs, ws, b))
        t_call = cuda_ms(lambda: int8_matmul(x, w, xs, ws, b), device_only=False)
        t_p = cuda_ms(lambda: int8_matmul_reference(x, w, xs, ws, b))
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            t_l = cuda_ms(lambda: torch._int_mm(x, w).to(torch.float32) * (xs * ws) + b)
            lib = f"{t_l:.4f}"
        else:
            t_l, lib = None, "n/a(_int_mm needs M>16, K%8=0, N%8=0)"
        nbytes = m * k + k * n + 4 + 8 * n + 4 * m * n
        t_b, by = bound(nbytes, 2.0 * m * n * k, bw, int8_peak)
        rows.append(dict(kernel="int8_matmul", m=m, k=k, n=n, ms=t_k, plain_ms=t_p,
                         library_ms=t_l, bound_ms=t_b, bound_by=by, err=err,
                         call_ms=t_call))
        print(f"[kernels] int8_matmul {m} {k} {n} | {t_k:.4f} {t_p:.4f} {lib} "
              f"{t_b:.3g} {by} | {err} | call {t_call:.4f}")
        if not lfc:  # only LFC has w4a16 layers
            continue

        # w4a16: LFC's linears have no bias
        xf = torch.randn((m, k), generator=g, device=dev) * 3
        wp = torch.randint(-128, 128, (k // 2, n), generator=g, device=dev,
                           dtype=torch.int8)
        ws4 = torch.rand(n, generator=g, device=dev) * 0.2 + 0.01
        tol = w4a16_tolerance(xf, wp, ws4)
        for bias, act in ((None, None), (b, "relu")):
            got = int4_weight_only_matmul(xf, wp, ws4, bias, act=act)
            want = int4_weight_only_matmul_reference(xf, wp, ws4, bias, act=act)
            torch.cuda.synchronize()
            if not bool(((got - want).abs() <= tol).all()):
                raise AssertionError(
                    f"int4_weight_only_matmul outside tolerance at {(m, k, n)} "
                    f"act={act}: max {float((got - want).abs().max())}")
        got = int4_weight_only_matmul(xf, wp, ws4)
        want = int4_weight_only_matmul_reference(xf, wp, ws4)
        err = float((got - want).abs().max())
        w_bf16 = unpack_int4_rows(wp).to(torch.bfloat16)
        t_k = cuda_ms(lambda: int4_weight_only_matmul(xf, wp, ws4))
        t_call = cuda_ms(lambda: int4_weight_only_matmul(xf, wp, ws4),
                         device_only=False)
        t_p = cuda_ms(lambda: int4_weight_only_matmul_reference(xf, wp, ws4))
        t_l = cuda_ms(lambda: torch.matmul(xf.to(torch.bfloat16), w_bf16)
                      .to(torch.float32) * ws4)
        nbytes = 4 * m * k + (k // 2) * n + 4 * n + 4 * m * n
        t_b, by = bound(nbytes, 2.0 * m * n * k, bw, bf16_peak)
        rows.append(dict(kernel="int4_weight_only_matmul", m=m, k=k, n=n, ms=t_k,
                         plain_ms=t_p, library_ms=t_l, bound_ms=t_b, bound_by=by,
                         err=err, call_ms=t_call))
        print(f"[kernels] int4_weight_only_matmul {m} {k} {n} | {t_k:.4f} "
              f"{t_p:.4f} {t_l:.4f} {t_b:.3g} {by} | {err:.3g} | call {t_call:.4f}")
    return rows


# int4_matmul at ragged shapes: K/2 = 3, 392 and 1; N off the 64-column tile
INT4_EDGE_SHAPES = [(1, 6, 10), (37, 784, 1024), (5, 2, 3)]


def phase_int4_kernel(dev, peaks):
    """int4_matmul (W4A8) at the Llama shapes and ragged ones, with and
    without bias, with ReLU, per-channel and scalar weight scales: bit for
    bit against its plain version, and timed. Returns the rows."""
    from brevitas_tpu_torch.kernels import int4_matmul, int4_matmul_reference, unpack_int4_rows

    bw, int8_peak, _ = peaks
    g = torch.Generator(device=dev).manual_seed(2)
    rows = []
    print("[kernels] int4_matmul M K N | kernel_ms plain_ms library_ms(torch._int_mm on "
          "unpacked 8-bit weights, not the same function) bound_ms bound_by | max_abs_err "
          "| call_ms")
    shapes = INT4_EDGE_SHAPES + [(m, k, n) for m in LLAMA_M for k, n in LLAMA_KN]
    for m, k, n in shapes:
        x = torch.randint(-128, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        wp = torch.randint(-128, 128, (k // 2, n), generator=g, device=dev, dtype=torch.int8)
        xs = torch.rand((), generator=g, device=dev) * 0.05 + 1e-3
        ws = torch.rand(n, generator=g, device=dev) * 0.05 + 1e-3
        b = torch.randn(n, generator=g, device=dev)
        err = 0.0
        for w_scale, bias, act in ((ws, b, None), (ws, None, None), (ws, b, "relu"),
                                   (xs * 2, None, "relu"), (xs * 2, b, None)):
            got = int4_matmul(x, wp, xs, w_scale, bias, act=act)
            want = int4_matmul_reference(x, wp, xs, w_scale, bias, act=act)
            torch.cuda.synchronize()
            err = max(err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(
                    f"int4_matmul differs from its plain version at {(m, k, n)} act={act} "
                    f"bias={bias is not None} per-channel={w_scale is ws}: max {err}")
        # the serving path passes a bias (the zero-point fold) and no activation
        t_k = cuda_ms(lambda: int4_matmul(x, wp, xs, ws, b))
        t_call = cuda_ms(lambda: int4_matmul(x, wp, xs, ws, b), device_only=False)
        t_p = cuda_ms(lambda: int4_matmul_reference(x, wp, xs, ws, b))
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            w8 = unpack_int4_rows(wp)
            t_l = cuda_ms(lambda: torch._int_mm(x, w8).to(torch.float32) * (xs * ws) + b)
            lib = f"{t_l:.4f}"
        else:
            t_l, lib = None, "n/a(_int_mm needs M>16, K%8=0, N%8=0)"
        nbytes = m * k + (k // 2) * n + 4 + 8 * n + 4 * m * n
        t_b, by = bound(nbytes, 2.0 * m * n * k, bw, int8_peak)
        rows.append(dict(kernel="int4_matmul", m=m, k=k, n=n, ms=t_k, plain_ms=t_p,
                         library_ms=t_l, bound_ms=t_b, bound_by=by, err=err, call_ms=t_call))
        print(f"[kernels] int4_matmul {m} {k} {n} | {t_k:.4f} {t_p:.4f} {lib} {t_b:.3g} "
              f"{by} | {err} | call {t_call:.4f}")
    return rows


# the repo's Llama configuration (bench.py's llama legs): about 80 M
# parameters, head_dim 64, SwiGLU hidden 2752
LLAMA_DIMS = dict(vocab_size=2000, dim=1024, depth=6, num_heads=16)
LLAMA_HIDDEN = 2752
PREFILL_BATCH, PREFILL_T = 8, 512
DECODE_BATCH, DECODE_MAX_LEN, DECODE_STEPS = 16, 1024, 64
DECODE_CHECK_STEPS, DECODE_CHECK_SEQS = 16, 2   # compared with a CPU copy
# int8_matmul's (K, N) in one Llama forward: q/k/v/out, gate/up, down, head
LLAMA_KN = [(1024, 1024), (1024, 2752), (2752, 1024), (1024, 2000)]
LLAMA_KN_COUNT = {(1024, 1024): 24, (1024, 2752): 12, (2752, 1024): 6, (1024, 2000): 1}
LLAMA_M = [PREFILL_BATCH * PREFILL_T, DECODE_BATCH]

# attention kernels: prefill (BH, Tq, Tk, D, causal, kv_groups) and decode
# (BH, l_half, D) at the given positions; the first rows are the main path's
ATTN_SHAPES = [(128, 512, 512, 64, True, 1), (6, 77, 45, 40, True, 2)]
DECODE_SHAPE = (256, 512, 64)
DECODE_POS = [63, 0, 511, 1023]
FLIP_SHARE = 1e-4   # codes may differ by one in at most this share of probabilities


def check_codes(got_out, got_codes, want_out, want_codes, v_codes, pv_scale, what):
    """Hold a kernel's attention output to its plain version's: the codes
    differ by at most one, in at most FLIP_SHARE of the probabilities; the
    kernel's output is exactly the PV product of its own codes; and each
    output row differs from the plain one by at most (flips in the row) *
    128 * p_scale * v_scale. Returns (flips, max |out diff|)."""
    delta = got_codes.to(torch.int32) - want_codes.to(torch.int32)
    flips = int((delta != 0).sum())
    if int(delta.abs().max()) > 1 or flips > FLIP_SHARE * delta.numel():
        raise AssertionError(f"{what}: codes differ by up to {int(delta.abs().max())}, "
                             f"in {flips} of {delta.numel()}")
    exact = torch.bmm(got_codes.double(), v_codes.double()).float() * pv_scale
    if not torch.equal(got_out, exact):
        raise AssertionError(f"{what}: output is not the PV product of its codes")
    row_flips = (delta != 0).sum(-1, keepdim=True).float()
    err = (got_out - want_out).abs()
    if bool((err > row_flips * 128 * pv_scale * (1 + 1e-6)).any()):
        raise AssertionError(f"{what}: output outside (row flips) x 128 x p_s x v_s")
    return flips, float(err.max())


def phase_attention_kernels(dev, peaks):
    """Both attention kernels at the main path's shapes and a ragged one,
    held against their plain versions code by code, and timed."""
    import torch.nn.functional as F

    from brevitas_tpu_torch.kernels import (
        int4kv_decode_attention,
        int4kv_decode_attention_reference,
        int8_attention,
        int8_attention_reference,
        unpack_kv_halves,
    )

    bw, int8_peak, _ = peaks
    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    print("[attn] kernel shape | kernel_ms plain_ms library_ms(bf16 SDPA, not the same "
          "function) bound_ms bound_by | code flips, max_abs_err")
    for bh, tq, tk, d, causal, groups in ATTN_SHAPES:
        q = torch.randint(-127, 128, (bh, tq, d), generator=g, device=dev, dtype=torch.int8)
        k = torch.randint(-127, 128, (bh // groups, tk, d), generator=g, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (bh // groups, tk, d), generator=g, device=dev,
                          dtype=torch.int8)
        # scores of standard deviation ~3; probabilities up to 0.25 span the codes
        qk = torch.tensor(3.0 / (127 ** 2 / 3 * d ** 0.5), device=dev)
        ps, vs = torch.tensor(0.25 / 255, device=dev), torch.tensor(0.02, device=dev)
        args = (qk, ps, vs, 255, causal, groups)
        got, got_codes = int8_attention(q, k, v, *args, return_codes=True)
        want, want_codes = int8_attention_reference(q, k, v, *args, return_codes=True)
        torch.cuda.synchronize()
        what = f"int8_attention {(bh, tq, tk, d)}"
        flips, err = check_codes(got, got_codes, want, want_codes,
                                 v.repeat_interleave(groups, 0), ps * vs, what)
        t_k = cuda_ms(lambda: int8_attention(q, k, v, *args))
        t_p = cuda_ms(lambda: int8_attention_reference(q, k, v, *args))
        # (1, BH, T, D): the 4-D layout SDPA's fused kernels take
        qb, kb, vb = (t.to(torch.bfloat16).repeat_interleave(
            1 if t is q else groups, 0)[None] for t in (q, k, v))
        t_l = cuda_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb, is_causal=causal))
        lims = (torch.arange(tq) + tk - tq + 1).clamp(0, tk)
        pairs = int(torch.where(lims > 0, lims, tk).sum()) * bh if causal else bh * tq * tk
        nbytes = bh * tq * d + 2 * (bh // groups) * tk * d + 4 * bh * tq * d + 12
        t_b, by = bound(nbytes, 4.0 * pairs * d, bw, int8_peak)
        rows.append(dict(kernel="int8_attention", shape=(bh, tq, tk, d), ms=t_k,
                         plain_ms=t_p, library_ms=t_l, bound_ms=t_b, bound_by=by,
                         err=err, flips=flips))
        print(f"[attn] int8_attention {(bh, tq, tk, d)} causal={causal} groups={groups} | "
              f"{t_k:.4f} {t_p:.4f} {t_l:.4f} {t_b:.4g} {by} | {flips} of "
              f"{got_codes.numel()}, {err:.3g}")

    bh, l_half, d = DECODE_SHAPE
    q = torch.randint(-127, 128, (bh, 1, d), generator=g, device=dev, dtype=torch.int8)
    kp = torch.randint(-128, 128, (bh, l_half, d), generator=g, device=dev, dtype=torch.int8)
    vp = torch.randint(-128, 128, (bh, l_half, d), generator=g, device=dev, dtype=torch.int8)
    # q codes ~ 73 and nibbles ~ 4.6 in standard deviation: scores of deviation ~3
    q_s, k_s = torch.tensor(0.01, device=dev), torch.tensor(3.0 / (73 * 4.6 * 0.01), device=dev)
    ps, vs = torch.tensor(0.25 / 255, device=dev), torch.tensor(0.1, device=dev)
    k_full, v_full = unpack_kv_halves(kp), unpack_kv_halves(vp)
    for pos in DECODE_POS:
        args = (pos, q_s, k_s, vs, ps, d)
        got, got_codes = int4kv_decode_attention(q, kp, vp, *args, return_codes=True)
        want, want_codes = int4kv_decode_attention_reference(q, kp, vp, *args,
                                                             return_codes=True)
        torch.cuda.synchronize()
        what = f"int4kv_decode_attention {(bh, l_half, d)} pos={pos}"
        flips, err = check_codes(got, got_codes, want, want_codes, v_full, ps * vs, what)
        t_k = cuda_ms(lambda: int4kv_decode_attention(q, kp, vp, *args))
        t_p = cuda_ms(lambda: int4kv_decode_attention_reference(q, kp, vp, *args))
        qb = q.to(torch.bfloat16)[None]
        kb = k_full[None, :, :pos + 1].to(torch.bfloat16)
        vb = v_full[None, :, :pos + 1].to(torch.bfloat16)
        t_l = cuda_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb))
        n_rows = min(l_half, pos + 1)
        nbytes = bh * d + 2 * bh * n_rows * d + 4 * bh * d + 12
        t_b, by = bound(nbytes, 4.0 * bh * (pos + 1) * d, bw, int8_peak)
        rows.append(dict(kernel="int4kv_decode_attention", shape=(bh, l_half, d), pos=pos,
                         ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=t_b, bound_by=by,
                         err=err, flips=flips))
        print(f"[attn] int4kv_decode_attention {(bh, l_half, d)} pos={pos} | {t_k:.4f} "
              f"{t_p:.4f} {t_l:.4f} {t_b:.4g} {by} | {flips} of {got_codes.numel()}, "
              f"{err:.3g}")
    return rows


def _to_cpu(x):
    from brevitas_tpu_torch.quant_tensor import QuantTensor

    if isinstance(x, QuantTensor):
        move = lambda t: t.cpu() if isinstance(t, torch.Tensor) else t  # noqa: E731
        return QuantTensor(move(x.value), move(x.scale), move(x.zero_point),
                           move(x.bit_width), signed=x.signed, training=x.training)
    return x.cpu()


def compare_with_cpu_copy(model, batch: np.ndarray, what: str) -> torch.Tensor:
    """Serve ``batch`` on the card and on a CPU copy of ``model``; hold each
    serving layer of the copy, fed the card's input to it, against the card's
    output, and the logits end to end. Returns the card's logits."""
    from brevitas_tpu_torch.graph.convert_int import (
        Int8InferenceLinear,
        WeightOnlyInt4InferenceLinear,
    )

    twins = (Int8InferenceLinear, WeightOnlyInt4InferenceLinear)
    cpu_model = copy.deepcopy(model).to("cpu")
    seen = []
    hooks = [mod.register_forward_hook(
        lambda mod, args, out, name=name: seen.append((name, args[0], out)))
        for name, mod in model.named_modules() if isinstance(mod, twins)]
    with torch.no_grad():
        logits = model(torch.from_numpy(batch).cuda())
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        cpu_logits = cpu_model(torch.from_numpy(batch))
        for name, inp, out in seen:
            twin = cpu_model.get_submodule(name)
            want = twin(_to_cpu(inp))
            got = out.cpu()
            if isinstance(twin, Int8InferenceLinear):
                ok, detail = torch.equal(got, want), "bit for bit"
            else:
                x = inp.value if hasattr(inp, "value") else inp
                tol = w4a16_tolerance(x.cpu(), twin.w_packed, twin.w_scale)
                ok, detail = bool(((got - want).abs() <= tol).all()), "within tolerance"
            print(f"[{what}] layer {name}: card vs CPU copy max |diff| "
                  f"{float((got - want).abs().max()):.3g} ({detail}: {ok})")
            if not ok:
                raise AssertionError(f"{what}: layer {name} disagrees with its CPU copy")
    logits_cpu = logits.cpu()
    if logits_cpu.shape != (batch.shape[0], 10) or not torch.isfinite(logits_cpu).all():
        raise AssertionError(f"{what}: logits of shape {tuple(logits_cpu.shape)} "
                             "or not finite")
    diff = float((logits_cpu - cpu_logits).abs().max())
    agree = float((logits_cpu.argmax(1) == cpu_logits.argmax(1)).float().mean())
    print(f"[{what}] logits card vs CPU copy: max |diff| {diff:.3g}, "
          f"bit for bit {torch.equal(logits_cpu, cpu_logits)}, argmax agreement {agree}")
    return logits


def phase_serve(dev):
    from brevitas_tpu_torch import graph as G
    from brevitas_tpu_torch.examples import serve

    _reset_launch_counts()
    out = serve.main(["--requests", "512", "--batch-size", str(SERVE_BATCH)])
    counts = _launch_counts()
    n8, n4 = counts["int8_matmul"], counts["int4_weight_only_matmul"]
    expected = 4 * (out["batches"] + 1)
    print(f"[serve] int8_matmul launches {n8} (expected {expected} = 4 x "
          f"({out['batches']} batches + 1 warm-up)), int4_weight_only_matmul {n4}")
    if n8 != expected or n4 != 0:
        raise AssertionError("serve: the int8 kernel was not launched on every layer")
    model = serve.build_int8_model(torch.Generator().manual_seed(0), dev)
    G.convert_integer_inference(model)
    batch = np.random.default_rng(0).random((SERVE_BATCH, 28, 28, 1), dtype=np.float32)
    compare_with_cpu_copy(model, batch, "serve")
    profile_batch(model, batch, "serve")
    return out, n8


def phase_lfc(dev):
    from brevitas_tpu_torch import graph as G
    from brevitas_tpu_torch.graph.convert_int import (
        Int8InferenceLinear,
        WeightOnlyInt4InferenceLinear,
    )
    from brevitas_tpu_torch.models import lfc

    launches = {}
    for bits, twin, kernel in ((4, WeightOnlyInt4InferenceLinear, "int4_weight_only_matmul"),
                               (8, Int8InferenceLinear, "int8_matmul")):
        model = lfc(bits, bits, bits, dropout=0.0,
                    generator=torch.Generator().manual_seed(0), device=dev)
        calib = np.random.default_rng(1).random((256, 28, 28, 1), dtype=np.float32)
        with torch.no_grad():
            model(torch.from_numpy(calib).to(dev))
        model.eval()
        G.convert_integer_inference(model)
        n_twins = sum(isinstance(m, twin) for m in model.modules())
        if n_twins != 4:
            raise AssertionError(f"lfc {bits}-bit: {n_twins} {twin.__name__} layers, not 4")
        batch = np.random.default_rng(2).random((LFC_BATCH, 28, 28, 1), dtype=np.float32)
        _reset_launch_counts()
        with torch.no_grad():
            model(torch.from_numpy(batch).to(dev))
        torch.cuda.synchronize()
        counts = _launch_counts()
        print(f"[lfc] {bits}-bit batch {LFC_BATCH}: launches {counts}")
        if counts[kernel] != 4 or sum(counts.values()) != 4:
            raise AssertionError(f"lfc {bits}-bit: expected 4 {kernel} launches")
        launches[kernel] = counts[kernel]
        compare_with_cpu_copy(model, batch, f"lfc{bits}")
        profile_batch(model, batch, f"lfc{bits}")
    return launches


def _launch_counts():
    from brevitas_tpu_torch import kernels as K

    return {"int8_matmul": K.int8_matmul.launches,
            "int4_matmul": K.int4_matmul.launches,
            "int4_weight_only_matmul": K.int4_weight_only_matmul.launches,
            "int8_attention": K.int8_attention.launches,
            "int4kv_decode_attention": K.int4kv_decode_attention.launches}


def _reset_launch_counts():
    from brevitas_tpu_torch import kernels as K

    for name in _launch_counts():
        getattr(K, name).launches = 0


def build_llama(dev, calib_ids: np.ndarray, kv_bit_width=None, w4a8=False):
    """bench.py's recipe: random weights from seed 0, one train-mode forward
    to calibrate the activation grids, eval, convert_integer_inference.
    ``w4a8``: 4-bit weights per output channel (the package's own preset
    Int4WeightPerChannelFloat), every linear then packed."""
    from brevitas_tpu_torch import config
    from brevitas_tpu_torch import graph as G
    from brevitas_tpu_torch.graph.convert_int import Int8InferenceAttention, Int8InferenceLinear
    from brevitas_tpu_torch.models import QuantLlama
    from brevitas_tpu_torch.quant.presets import Int4WeightPerChannelFloat

    model = QuantLlama(bit_width=8, kv_bit_width=kv_bit_width,
                       weight_quant=Int4WeightPerChannelFloat if w4a8 else None,
                       generator=torch.Generator().manual_seed(0), device=dev, **LLAMA_DIMS)
    with torch.no_grad():
        model(torch.from_numpy(calib_ids).to(dev))
    model.eval()
    policy = config.INT4_KV_CACHE
    if kv_bit_width:
        config.INT4_KV_CACHE = "1"  # the packed cache, as bench.py's llama_decode4 leg sets it
    try:
        G.convert_integer_inference(model)
    finally:
        config.INT4_KV_CACHE = policy
    n_attn = sum(isinstance(m, Int8InferenceAttention) for m in model.modules())
    n_lin = sum(isinstance(m, Int8InferenceLinear) for m in model.modules())
    if (n_attn, n_lin) != (6, 43):
        raise AssertionError(f"llama: {n_attn} attention and {n_lin} linear twins, "
                             "expected 6 and 43")
    packed = {m.kv_int4 for m in model.modules() if isinstance(m, Int8InferenceAttention)}
    if packed != {bool(kv_bit_width)}:
        raise AssertionError(f"llama: packed KV cache {packed}, expected {bool(kv_bit_width)}")
    packed_w = {m.w_packed is not None for m in model.modules()
                if isinstance(m, Int8InferenceLinear)}
    if packed_w != {w4a8}:
        raise AssertionError(f"llama: packed weights {packed_w}, expected {w4a8}")
    return model


def gemm_expect(w4a8: bool, n: int) -> dict:
    """The GEMM launches of ``n`` Llama linears: all int4_matmul for W4A8,
    all int8_matmul otherwise."""
    return {"int4_matmul": n if w4a8 else 0, "int8_matmul": 0 if w4a8 else n}


class AttentionTap:
    """Records the inputs and outputs of every attention twin of a model on
    the card (first ``n`` sequences, in call order, prefill or decode), or
    replays them into a CPU copy: there each twin's input must equal the
    card's bit for bit, its own output is held to the card's row by row (a
    row: one token's vector; a probability code that flips at a .5 tie
    changes only its own row), and the card's output is passed on, so the
    rest of the copy sees exactly what the card saw."""

    def __init__(self, model, n: int, replay=None):
        from brevitas_tpu_torch.graph.convert_int import Int8InferenceAttention

        self.n, self.replay, self.record = n, replay, []
        self.rows = self.differ = 0
        self.max_diff = 0.0
        self.mods = [(name, mod) for name, mod in model.named_modules()
                     if isinstance(mod, Int8InferenceAttention)]
        for name, mod in self.mods:
            mod.forward = self._wrap(mod.forward, name, False)
            mod.decode_step = self._wrap(mod.decode_step, name, True)

    def _wrap(self, fn, name, decode):
        def call(x, *args, **kw):
            result = fn(x, *args, **kw)
            y = result[0] if decode else result
            if self.replay is None:
                self.record.append((name, x[:self.n].cpu(), y[:self.n].cpu()))
                return result
            want_name, want_x, want_y = self.replay[len(self.record)]
            self.record.append(name)
            if want_name != name or not torch.equal(x, want_x):
                raise AssertionError(f"{name}: the CPU copy's input differs from the card's")
            self.rows += y.numel() // y.shape[-1]
            self.differ += int((y != want_y).any(-1).sum())
            self.max_diff = max(self.max_diff, float((y - want_y).abs().max()))
            return (want_y, *result[1:]) if decode else want_y
        return call

    def detach(self):
        for _, mod in self.mods:
            del mod.forward, mod.decode_step


def check_replay(tap: AttentionTap, got_logits, want_logits, what: str) -> None:
    """Attention rows of the CPU copy against the card's (at most 1 % may
    differ), and the logits of the copy fed the card's attention outputs:
    bit for bit."""
    print(f"[{what}] attention twins of the CPU copy fed the card's inputs: "
          f"{tap.differ} of {tap.rows} rows differ, max |diff| {tap.max_diff:.3g}")
    if tap.differ > 0.01 * tap.rows:
        raise AssertionError(f"{what}: {tap.differ} attention rows differ from the CPU copy")
    if not torch.equal(got_logits, want_logits):
        raise AssertionError(f"{what}: logits of the CPU copy fed the card's attention "
                             "outputs differ from the card's")
    print(f"[{what}] logits of the CPU copy fed the card's attention outputs: bit for bit")


def compare_logits(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """Free-running CPU copy: a flipped probability code feeds every later
    position and layer, and random weights leave the logits close together
    (one flip in block 1 moved 4.5 % of the argmaxes in a first run), so the
    bound is loose: argmax agreement of at least 90 % and max |diff| within
    10 % of the largest logit."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: logits not finite")
    diff = float((got - want).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    span = float(want.abs().max())
    print(f"[{what}] logits card vs free-running CPU copy: max |diff| {diff:.3g} of span "
          f"{span:.3g}, bit for bit {torch.equal(got, want)}, argmax agreement {agree}")
    if agree < 0.9 or diff > 0.1 * span:
        raise AssertionError(f"{what}: logits disagree with the CPU copy")


def profile_steps(fn, what: str, unit: str, n: int = 3) -> dict:
    """Device busy time by kernel from torch.profiler over ``n`` calls of
    ``fn`` (each ending in a synchronize), beside their wall time; the rest
    of the wall time the card is idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        fn()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = [(e.key, e.self_device_time_total / 1e3 / n) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("Activity Buffer")]
    busy_ms = sum(t for _, t in rows)
    top = sorted(rows, key=lambda r: -r[1])[:8]
    print(f"[{what}] profile per {unit}: device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms "
          f"wall under the profiler (idle share {1 - busy_ms / wall_ms:.3f}); top device ms: "
          + ", ".join(f"{k[:48]} {t:.4f}" for k, t in top))
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "idle_share": 1 - busy_ms / wall_ms,
            "top": [(k[:64], t) for k, t in top]}


def profile_batch(model, batch: np.ndarray, what: str) -> None:
    """Where one served batch's time goes, host copy in and out included."""
    x = torch.from_numpy(batch)
    profile_steps(lambda: model(x.cuda()).cpu(), what, f"batch of {batch.shape[0]}", n=5)


def phase_llama_prefill(dev, w4a8=False) -> dict:
    """Full-width Llama prefill, 8 x 512 causal, on the converted model."""
    what = "llama_w4a8_prefill" if w4a8 else "llama_prefill"
    vocab = LLAMA_DIMS["vocab_size"]
    calib = np.random.default_rng(0).integers(0, vocab, (PREFILL_BATCH, PREFILL_T))
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, vocab, (PREFILL_BATCH, PREFILL_T))).to(dev)
    model = build_llama(dev, calib, w4a8=w4a8)
    tap = AttentionTap(model, 1)
    _reset_launch_counts()
    with torch.no_grad():
        logits = model(ids)
    torch.cuda.synchronize()
    counts = _launch_counts()
    tap.detach()
    print(f"[{what}] {PREFILL_BATCH} x {PREFILL_T} causal: launches {counts}")
    expected = {"int8_attention": 6, **gemm_expect(w4a8, 43)}
    if any(counts[k] != v for k, v in expected.items()):
        raise AssertionError(f"{what}: expected launches {expected} per forward")
    if tuple(logits.shape) != (PREFILL_BATCH, PREFILL_T, vocab):
        raise AssertionError(f"{what}: logits of shape {tuple(logits.shape)}")

    cpu_model = copy.deepcopy(model).to("cpu")
    with torch.no_grad():
        compare_logits(logits[:1].cpu(), cpu_model(ids[:1].cpu()), what)
        replay = AttentionTap(cpu_model, 1, replay=tap.record)
        check_replay(replay, cpu_model(ids[:1].cpu()), logits[:1].cpu(), what)
    del cpu_model

    def forward():
        model(ids)
        torch.cuda.synchronize()

    with torch.no_grad():
        forward()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            forward()
            times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    out = {"ms_per_forward": ms, "sequences_per_s": PREFILL_BATCH / ms * 1e3,
           "tokens_per_s": PREFILL_BATCH * PREFILL_T / ms * 1e3, "launches": counts}
    print(f"[{what}] {ms:.3f} ms per forward (median of 5, host clock with "
          f"synchronize): {out['sequences_per_s']:.1f} sequences/s, "
          f"{out['tokens_per_s']:.0f} tokens/s")
    out["profile"] = profile_steps(forward, what, "forward")
    return out


def greedy_decode(model, first: torch.Tensor, steps: int, max_len: int = DECODE_MAX_LEN):
    """``steps`` greedy decode steps from the tokens ``first`` (B, 1) at
    position 0 on a fresh cache of ``max_len``; returns the tokens fed
    (steps, B, 1) and the logits (steps, B, vocab)."""
    caches = model.init_decode_caches(first.shape[0], max_len)
    tok, fed, logits = first, [], []
    for pos in range(steps):
        fed.append(tok)
        out, caches = model.decode_step(tok, caches, pos)
        logits.append(out[:, 0])
        tok = out.argmax(-1)
    return torch.stack(fed), torch.stack(logits)


def check_decode(model, tap: AttentionTap, fed, logits, max_len: int, what: str) -> None:
    """A decode run on the card (``fed`` and ``logits`` from greedy_decode,
    its attention twins recorded by ``tap``) against a CPU copy fed the same
    tokens for the tap's first sequences: free-running (compare_logits),
    then with the card's attention outputs replayed (check_replay)."""
    n = tap.n
    cpu_model = copy.deepcopy(model).to("cpu")

    def cpu_decode():
        caches, out = cpu_model.init_decode_caches(n, max_len), []
        for pos in range(fed.shape[0]):
            y, caches = cpu_model.decode_step(fed[pos, :n].cpu(), caches, pos)
            out.append(y[:, 0])
        return torch.stack(out)

    with torch.no_grad():
        compare_logits(logits[:, :n].cpu(), cpu_decode(), what)
        replay = AttentionTap(cpu_model, n, replay=tap.record)
        check_replay(replay, cpu_decode(), logits[:, :n].cpu(), what)


def phase_llama_decode(dev, kv_bit_width, w4a8=False) -> dict:
    """64 greedy decode steps at batch 16 against a 1024-position cache:
    int8 KV (kv_bit_width None) or int4-packed KV (kv_bit_width 4)."""
    what = ("llama_w4a8_decode_" if w4a8 else "llama_decode_") + (
        "int4kv" if kv_bit_width else "int8kv")
    vocab = LLAMA_DIMS["vocab_size"]
    rng = np.random.default_rng(0)
    model = build_llama(dev, rng.integers(0, vocab, (DECODE_BATCH, 64)), kv_bit_width,
                        w4a8=w4a8)
    first = torch.from_numpy(rng.integers(0, vocab, (DECODE_BATCH, 1))).to(dev)
    with torch.no_grad():
        greedy_decode(model, first, DECODE_STEPS)  # warm-up
        torch.cuda.synchronize()
        _reset_launch_counts()
        t0 = time.perf_counter()
        fed, logits = greedy_decode(model, first, DECODE_STEPS)
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
    counts = _launch_counts()
    print(f"[{what}] {DECODE_STEPS} steps x batch {DECODE_BATCH}, cache {DECODE_MAX_LEN}: "
          f"launches {counts}")
    expected = {"int8_attention": 0, **gemm_expect(w4a8, 43 * DECODE_STEPS),
                "int4kv_decode_attention": 6 * DECODE_STEPS if kv_bit_width else 0}
    if any(counts[k] != v for k, v in expected.items()):
        raise AssertionError(f"{what}: expected launches {expected} over "
                             f"{DECODE_STEPS} steps")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{what}: logits not finite")

    # the check: the first steps again on a fresh cache, the attention twins
    # recorded, then a CPU copy fed the same tokens, free-running and with
    # the card's attention outputs replayed
    tap = AttentionTap(model, DECODE_CHECK_SEQS)
    with torch.no_grad():
        fed, logits = greedy_decode(model, first, DECODE_CHECK_STEPS)
    tap.detach()
    check_decode(model, tap, fed, logits, DECODE_MAX_LEN, what)

    out = {"ms_per_step": total_ms / DECODE_STEPS,
           "tokens_per_s": DECODE_BATCH * DECODE_STEPS / total_ms * 1e3, "launches": counts}
    print(f"[{what}] {out['ms_per_step']:.3f} ms per step, {out['tokens_per_s']:.0f} "
          "tokens/s (host clock over the steps, synchronized at the end)")

    def eight_steps():
        greedy_decode(model, first, 8)
        torch.cuda.synchronize()

    prof = profile_steps(eight_steps, what, "8 steps")
    out["profile"] = prof
    return out


def phase_serve_decode(dev) -> dict:
    """examples.serve --decode at its defaults, int8 and int4-packed KV: the
    launches of its warm-up and three timed generations, then the model it
    timed checked as in phase_llama_decode: its greedy logits over the
    whole generation against a CPU copy, all sequences."""
    from brevitas_tpu_torch.examples import serve

    outs = {}
    steps = SERVE_DECODE["tokens"]
    for kv_bits in (0, 4):
        what = f"serve_decode_kv{kv_bits or 8}"
        argv = ["--decode", "--decode-tokens", str(steps),
                "--decode-batch", str(SERVE_DECODE["batch"]),
                "--decode-dim", str(SERVE_DECODE["dim"]), "--device", str(dev)]
        argv += ["--kv-bits", str(kv_bits)] if kv_bits else []
        _reset_launch_counts()
        out, model, first, max_len = serve.decode_demo(serve.parse_args(argv))
        counts = _launch_counts()
        runs = 4 * steps  # a warm-up and three timed generations
        per_step = SERVE_DECODE_BLOCKS * (4 + 2) + 1
        expected = {"int8_matmul": per_step * runs, "int4_matmul": 0, "int8_attention": 0,
                    "int4kv_decode_attention": SERVE_DECODE_BLOCKS * runs if kv_bits else 0}
        print(f"[{what}] launches {counts} over {runs} steps")
        if any(counts[k] != v for k, v in expected.items()):
            raise AssertionError(f"{what}: expected launches {expected}")

        tap = AttentionTap(model, SERVE_DECODE["batch"])
        with torch.no_grad():
            fed, logits = greedy_decode(model, first, steps, max_len)
        tap.detach()
        with torch.no_grad():
            served = model.generate(first, steps, max_len)
        if not torch.equal(logits.argmax(-1).T, served):
            raise AssertionError(f"{what}: the served tokens differ from the argmaxes of "
                                 "the checked logits")
        check_decode(model, tap, fed, logits, max_len, what)

        def eight_steps():
            greedy_decode(model, first, 8, max_len)
            torch.cuda.synchronize()

        out["profile"] = profile_steps(eight_steps, what, "8 steps")
        out["launches"] = counts
        outs[what] = out
    return outs


def kernel_summary(rows, name, m, launches, source, replaces, library_note=None):
    """Times of one request batch on the main path: the kernel's four LFC
    launches at batch ``m``."""
    per_kn = {(r["k"], r["n"]): r for r in rows if r["kernel"] == name and r["m"] == m}
    sel = [per_kn[kn] for kn in LFC_KN]
    bytes_t = sum(r["bound_ms"] for r in sel if r["bound_by"] == "bytes")
    ops_t = sum(r["bound_ms"] for r in sel if r["bound_by"] == "operations")
    lib = None if any(r["library_ms"] is None for r in sel) \
        else sum(r["library_ms"] for r in sel)
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["err"] for r in rows if r["kernel"] == name),
        "ms": sum(r["ms"] for r in sel), "plain_ms": sum(r["plain_ms"] for r in sel),
        "call_ms": sum(r["call_ms"] for r in sel),
        "bound_ms": bytes_t + ops_t, "bound_by": "bytes" if bytes_t >= ops_t else "operations",
        "library_ms": lib, "batch_m": m,
    }
    if lib is None and library_note:
        entry["library_note"] = library_note
    return entry


def llama_gemm_sums(rows, m: int, kernel: str = "int8_matmul") -> dict:
    """A GEMM kernel's times over one Llama forward (prefill, M = 4096) or one
    decode step (M = 16): its 43 launches at their shapes."""
    per_kn = {(r["k"], r["n"]): r for r in rows if r["kernel"] == kernel and r["m"] == m}
    sums = {key: sum(per_kn[kn][key] * c for kn, c in LLAMA_KN_COUNT.items())
            for key in ("ms", "plain_ms", "bound_ms", "call_ms")}
    by = {b: sum(per_kn[kn]["bound_ms"] * c for kn, c in LLAMA_KN_COUNT.items()
                 if per_kn[kn]["bound_by"] == b) for b in ("bytes", "operations")}
    sums["bound_by"] = max(by, key=by.get)
    libs = [per_kn[kn]["library_ms"] for kn in LLAMA_KN_COUNT]
    sums["library_ms"] = None if None in libs else sum(
        per_kn[kn]["library_ms"] * c for kn, c in LLAMA_KN_COUNT.items())
    return sums


def attention_summary(row, name, launches, source, replaces):
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": row["max_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None,
        "library_note": "no PyTorch call computes this function (int8 scores, a "
                        "requantized probability grid); sdpa_bf16_ms is a yardstick only",
        "sdpa_bf16_ms": row["library_ms"],
        "shape": row["shape"], "pos": row.get("pos"), "code_flips": row["flips_total"],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a card",
              file=sys.stderr)
        return 2
    # the plain versions are the reference: full float32 matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    phase_build()
    phase_card()
    kind = torch.cuda.get_device_name(0)
    sheet, peaks = peaks_for(kind)
    print(f"[kernels] bounds from the {sheet} data sheet: {peaks[0] / 1e12} TB/s, "
          f"{peaks[1] / 1e12} int8 TOP/s, {peaks[2] / 1e12} bf16 TFLOP/s")
    rows = phase_kernels(dev, peaks)
    rows += phase_int4_kernel(dev, peaks)
    attn_rows = phase_attention_kernels(dev, peaks)
    serve_out, serve_int8 = phase_serve(dev)
    lfc_launches = phase_lfc(dev)
    prefill = phase_llama_prefill(dev)
    decode = {"int8kv": phase_llama_decode(dev, None), "int4kv": phase_llama_decode(dev, 4)}
    w4a8_prefill = phase_llama_prefill(dev, w4a8=True)
    w4a8_decode = phase_llama_decode(dev, None, w4a8=True)
    serve_decode = phase_serve_decode(dev)

    int8_by_path = {"serve": serve_int8, "lfc8": lfc_launches["int8_matmul"],
                    "llama_prefill": prefill["launches"]["int8_matmul"],
                    **{f"llama_decode_{k}": v["launches"]["int8_matmul"]
                       for k, v in decode.items()},
                    **{k: v["launches"]["int8_matmul"] for k, v in serve_decode.items()}}
    int4_by_path = {"llama_w4a8_prefill": w4a8_prefill["launches"]["int4_matmul"],
                    "llama_w4a8_decode": w4a8_decode["launches"]["int4_matmul"]}
    int4_decode = llama_gemm_sums(rows, DECODE_BATCH, "int4_matmul")
    int4_entry = {
        "name": "int4_matmul", "route": "cuda",
        "source": "brevitas_tpu_torch/csrc/int4_matmul.cu",
        "replaces": "brevitas_tpu/kernels/int4.py:126",
        "launches": sum(int4_by_path.values()),
        "max_abs_err": max(r["err"] for r in rows if r["kernel"] == "int4_matmul"),
        "ms": int4_decode["ms"], "plain_ms": int4_decode["plain_ms"],
        "call_ms": int4_decode["call_ms"], "bound_ms": int4_decode["bound_ms"],
        "bound_by": int4_decode["bound_by"], "library_ms": None,
        "library_note": "one W4A8 decode step (43 launches at M 16): torch._int_mm needs "
                        "M > 16, and no PyTorch call takes packed int4 weights",
        "per": "one W4A8 Llama decode step: 43 launches at M 16",
        "launches_by_path": int4_by_path,
        "llama_prefill_forward": llama_gemm_sums(rows, PREFILL_BATCH * PREFILL_T,
                                                 "int4_matmul"),
    }
    int8_entry = kernel_summary(rows, "int8_matmul", SERVE_BATCH, sum(int8_by_path.values()),
                                "brevitas_tpu_torch/csrc/int8_matmul.cu",
                                "brevitas_tpu/kernels/int_matmul.py:90",
                                "torch._int_mm needs N % 8 == 0; LFC's head has N = 10")
    int8_entry.update(launches_by_path=int8_by_path,
                      llama_prefill_forward=llama_gemm_sums(rows, PREFILL_BATCH * PREFILL_T),
                      llama_decode_step=llama_gemm_sums(rows, DECODE_BATCH))
    for r in attn_rows:
        r["flips_total"] = sum(x["flips"] for x in attn_rows if x["kernel"] == r["kernel"])
        r["max_err"] = max(x["err"] for x in attn_rows if x["kernel"] == r["kernel"])
    report = {"kernels": [
        int8_entry,
        int4_entry,
        kernel_summary(rows, "int4_weight_only_matmul", LFC_BATCH,
                       lfc_launches["int4_weight_only_matmul"],
                       "brevitas_tpu_torch/csrc/int4_weight_only_matmul.cu",
                       "brevitas_tpu/kernels/int4.py:229"),
        attention_summary(attn_rows[0], "int8_attention",
                          prefill["launches"]["int8_attention"]
                          + w4a8_prefill["launches"]["int8_attention"],
                          "brevitas_tpu_torch/csrc/int8_attention.cu",
                          "brevitas_tpu/kernels/int8_attention.py:98"),
        attention_summary(next(r for r in attn_rows if r.get("pos") == DECODE_STEPS - 1),
                          "int4kv_decode_attention",
                          decode["int4kv"]["launches"]["int4kv_decode_attention"]
                          + serve_decode["serve_decode_kv4"]["launches"][
                              "int4kv_decode_attention"],
                          "brevitas_tpu_torch/csrc/int4kv_decode_attention.cu",
                          "brevitas_tpu/kernels/int8_attention.py:324"),
    ], "serve": serve_out,
        "llama_prefill": {k: v for k, v in prefill.items() if k != "profile"},
        "llama_decode": {k: {kk: vv for kk, vv in v.items() if kk != "profile"}
                         for k, v in decode.items()},
        "llama_w4a8_prefill": {k: v for k, v in w4a8_prefill.items() if k != "profile"},
        "llama_w4a8_decode": {k: v for k, v in w4a8_decode.items() if k != "profile"},
        "serve_decode": {k: {kk: vv for kk, vv in v.items() if kk != "profile"}
                         for k, v in serve_decode.items()},
        "seconds": time.perf_counter() - t0}
    print(f"[done] {report['seconds']:.1f} s")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
