#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA card.

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
             shapes (M 32), and both tensor-core GEMMs and int4_matmul at
             ragged shapes that reach every launcher variant and load path,
             on random full-range codes, held against their plain PyTorch
             versions on the card: int8 (with and without bias and ReLU) and
             W4A8 bit for bit, w4a16 within 1e-5 * sum|bf16(x)||w| *
             |w_scale| (its largest share of that bound printed). Each shape
             prints the variant its launcher took. Median times (CUDA
             events) of the kernel, the plain version and one library call,
             beside the least time the card could take; int8_matmul and
             int4_matmul also at every forced K-split count (tiled against
             split-K). int4_matmul first runs structural probes: one-hot x
             against packed weights holding a K index in one nibble half and
             an N index in the other, so a wrong fragment or nibble mapping
             names the first output it breaks.
4. attn    - int8_attention at (BH, T, D) = (128, 512, 64) causal and a ragged
             grouped-query shape; int4kv_decode_attention at (BH, l_half, D) =
             (256, 512, 64) with pos in {63, 0, 511, 1023}, and at a ragged
             grouped-query shape (6, 77, 40), 2 groups, on both sides of
             l_half, each printing its launcher's variant; at every forced
             cluster size at pos 63, 511 and 1023; and, checked only, at
             (2, 262144, 8), whose chunks go in tiles, over a cluster, with
             their scores in a scratch buffer, and at D 33. Held to the plain
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
11. lstm_kernels - quant_lstm_cell's forward, its stage-table build and
             its backward at the QuantLSTM QAT leg's shape (B 64, H 512),
             unaligned ones ((3, 100), (3, 101)) and (1024, 512), with sa and
             ss per column, per gate block and one value, gates and scales
             drawn so that every clamp is reached: the table rule in Python
             equal to the launcher's; the tables bit for bit against the
             plain tables; the forward bit for bit against the plain version
             on the direct chain and on the tables, and with two addends (a
             strided float32 step of a projection, bf16 contiguous and
             strided: the kernel's gates equal torch's add, h and c' the
             plain version on it, the gradients to xp and p those through
             .to() and +); dgates and dc within rtol 1e-5, atol 1e-6 of the
             plain version's autograd; each scale gradient within 1e-5 * sum
             |term| of the float64 sum of the plain version's per-element
             terms, and the same bits on a second run. Times as above, each
             path apart and the table build.
11b. fake_quant_kernels - fake_quant's forward and backward kernels at the
             shapes of an lfc_qat step ((1024, 784), (1024, 1024), (10, 1024))
             and an unaligned (3, 5, 7), zero points 0 and 3, both clamp
             modes, every clamp reached: forward and dx bit for bit against
             the plain versions on the card; dscale and dzp within 1e-5 *
             sum |term| of the float64 sum of the plain terms; the same bits
             on a second run. Times as above; the library point is torch's
             own fake-quant ops, which multiply by 1/s (the Pallas kernel's
             function, not the port's).
12. lstm_qat - bench.py's quantlstm_int8_qat leg at full width: QuantLSTM(128,
             512, num_layers=2) with the leg's quantizers and a Linear(512, 10)
             head on y[:, -1]; one calibration forward (the module cell: no
             cell kernel launch), convert_runtime_stats_to_parameter, then a
             warm-up and 5 timed Adam steps (lr 1e-3, every parameter, the
             learned scales included) at batch 64, sequence 64: 128 forward
             and 128 backward cell launches and 2 table builds a step, and
             (from a profile of one forward) no per-step gate add or bf16
             cast of the projection. A copy made before the
             first step runs the same steps through the module cell
             (fused_cell = False): the first step's loss the same bits and
             its weight gradients within 1e-4, each step's loss within 1e-3,
             each weight's total update within 0.3 of its norm. Run twice:
             float32 operands, and bf16 (set_compute_dtype, bench's
             default), whose copy runs the same fused step on the cell's
             plain version. Each step also launches fake_quant 18 times each
             way (each layer's input and 8 gate-weight quantizers).
12b. lfc_qat - bench.py's lfc_int4_qat leg at full width, nothing cut:
             lfc(4, 4, 4, dropout=0.0), batch 1024, the square hinge loss,
             Adam lr 1e-3 and clip_weights(-1, 1) through the trainer's
             train_step, data drawn as _scanned_train draws it; a warm-up and
             30 timed steps (one scanned epoch), in bf16 operands (bench's
             default) and in float32. 8 fake_quant and 7 fake_quant_backward
             launches a step. A copy on the card runs the plain chain in every
             quantizer: the warm-up's loss and every gradient the same bits,
             each later step's loss difference reported; a CPU copy's first
             loss within 1e-5 (BatchNorm's reduction order). ms per step,
             images/s, device busy time and idle share.
12c. bnn_pynq - examples.bnn_pynq.main(["--network", "LFC_4W4A", "--dataset",
             "synthetic", "--epochs", "1"]) on the card, its launches counted.
13. report - one {"kernels": [...]} line; the last line is
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

import contextlib
import copy
import gc
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
# the same data sheets' float32 and float64 rates outside the tensor cores
VECTOR_PEAKS = {"H100 SXM": (67e12, 34e12), "H100 PCIe": (51e12, 26e12)}


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
            if any(w in line.lower() for w in ("registers", "spill", "error", "warning",
                                                 "wgmma", "performance")):
                print(f"[build] {name}: {line.strip()}")


CARD = ["not read"]  # nvidia-smi's name and power limit, printed beside timings


def phase_card() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print("[card] nvidia-smi name, power.limit:")
    print(line)
    CARD[0] = line
    return line


# ragged shapes that reach every variant and edge path of the two tensor-core
# GEMMs: split-K and tiled launches, TMA and masked byte loads (N % 16 != 0,
# K % 16 != 0), ragged last tiles in M, N and K, and K/2 off the 32-row slab
INT8_EDGE_SHAPES = [(1, 784, 10), (37, 784, 1024), (5, 100, 3), (200, 2752, 1000)]
W4A16_EDGE_SHAPES = [(1, 784, 10), (37, 100, 3), (1024, 784, 1000)]


def check_int8(x, w, xs, ws, b, what) -> float:
    """int8_matmul bit for bit against its plain version, with and without
    bias and ReLU; returns the largest difference (0)."""
    from brevitas_tpu_torch.kernels import int8_matmul, int8_matmul_reference

    for bias in (b, None):
        for act in (None, "relu"):
            got = int8_matmul(x, w, xs, ws, bias, act=act)
            want = int8_matmul_reference(x, w, xs, ws, bias, act=act)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"int8_matmul differs from its plain version at {what} act={act} "
                    f"bias={bias is not None}: max {float((got - want).abs().max())}")
    return float((got - want).abs().max())


def check_w4a16(x, wp, ws, b, what) -> tuple:
    """int4_weight_only_matmul within 1e-5 * sum|bf16(x)||w| * |w_scale| of its
    plain version, without bias and with bias and ReLU; returns the largest
    difference without bias and the largest ratio of a difference to its
    bound."""
    from brevitas_tpu_torch.kernels import (
        int4_weight_only_matmul,
        int4_weight_only_matmul_reference,
    )

    tol = w4a16_tolerance(x, wp, ws)
    ratio = 0.0
    for bias, act in ((b, "relu"), (None, None)):
        got = int4_weight_only_matmul(x, wp, ws, bias, act=act)
        want = int4_weight_only_matmul_reference(x, wp, ws, bias, act=act)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        if not bool((diff <= tol).all()):
            raise AssertionError(
                f"int4_weight_only_matmul outside tolerance at {what} act={act}: max "
                f"{float(diff.max())} (tolerance there {float(tol.flatten()[diff.argmax()])})")
        ratio = max(ratio, float((diff / tol.clamp_min(1e-30)).max()))
    return float(diff.max()), ratio


def phase_kernels(dev, peaks):
    """Per (kernel, M, K, N): correctness, the launcher's variant and times.
    Returns the rows of the main-path shapes."""
    from brevitas_tpu_torch.kernels import (
        int4_weight_only_matmul,
        int4_weight_only_matmul_reference,
        int8_matmul,
        int8_matmul_reference,
        unpack_int4_rows,
    )
    from brevitas_tpu_torch.kernels.int4 import int4_weight_only_matmul_plan
    from brevitas_tpu_torch.kernels.int_matmul import int8_matmul_plan

    bw, int8_peak, bf16_peak = peaks
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    print("[kernels] kernel M K N variant | kernel_ms plain_ms library_ms bound_ms "
          "bound_by | max_abs_err | call_ms (device times; call_ms includes the "
          "host's launch overhead)")
    main = ([(m, k, n) for m in SHAPES_M for k, n in SHAPES_KN]
            + [(m, k, n) for m in LLAMA_M for k, n in LLAMA_KN]
            + [(SERVE_DECODE["batch"], k, n) for k, n in SERVE_DECODE_KN])
    edges = {(m, k, n, "int8") for m, k, n in INT8_EDGE_SHAPES} | {
        (m, k, n, "w4a16") for m, k, n in W4A16_EDGE_SHAPES}
    shapes = INT8_EDGE_SHAPES + [s for s in W4A16_EDGE_SHAPES if s not in INT8_EDGE_SHAPES] \
        + main
    for m, k, n in shapes:
        # int8: the serving path passes a bias and no activation
        x = torch.randint(-128, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        w = torch.randint(-128, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        xs = torch.rand((), generator=g, device=dev) * 0.05 + 1e-3
        ws = torch.rand(n, generator=g, device=dev) * 0.05 + 1e-3
        b = torch.randn(n, generator=g, device=dev)
        plan = int8_matmul_plan(x, w)
        if (m, k, n, "int8") in edges or (m, k, n) in main:
            err = check_int8(x, w, xs, ws, b, (m, k, n))
        if (m, k, n) not in main:
            if (m, k, n, "int8") in edges:
                print(f"[kernels] int8_matmul {m} {k} {n} {plan} | edge shape: bit for bit "
                      "with and without bias and ReLU")
        else:
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
                             call_ms=t_call, variant=plan))
            print(f"[kernels] int8_matmul {m} {k} {n} {plan} | {t_k:.4f} {t_p:.4f} {lib} "
                  f"{t_b:.3g} {by} | {err} | call {t_call:.4f}")
        lfc = m in SHAPES_M and (k, n) in SHAPES_KN
        if not lfc and (m, k, n, "w4a16") not in edges:  # only LFC has w4a16 layers
            continue

        # w4a16: LFC's linears have no bias
        xf = torch.randn((m, k), generator=g, device=dev) * 3
        wp = torch.randint(-128, 128, (k // 2, n), generator=g, device=dev,
                           dtype=torch.int8)
        ws4 = torch.rand(n, generator=g, device=dev) * 0.2 + 0.01
        plan = int4_weight_only_matmul_plan(xf, wp)
        err, ratio = check_w4a16(xf, wp, ws4, b, (m, k, n))
        if not lfc:
            print(f"[kernels] int4_weight_only_matmul {m} {k} {n} {plan} | edge shape: "
                  f"within the bound, max |diff| {err:.3g}, {ratio:.3g} of the bound")
            continue
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
                         err=err, err_of_bound=ratio, call_ms=t_call, variant=plan))
        print(f"[kernels] int4_weight_only_matmul {m} {k} {n} {plan} | {t_k:.4f} "
              f"{t_p:.4f} {t_l:.4f} {t_b:.3g} {by} | {err:.3g} ({ratio:.3g} of the bound) "
              f"| call {t_call:.4f}")
    return rows


# int8_matmul's launcher splits K over a cluster when its output tiles fill
# fewer than half the SMs; these shapes time every split count, forced
SPLIT_SHAPES = [(16, 1024, 1024), (16, 2752, 1024), (128, 1024, 1024), (1024, 1024, 1024),
                (4096, 1024, 1024)]
SPLITS = (1, 2, 4, 8)


def phase_int8_crossover(dev) -> dict:
    """int8_matmul's tiled (1 split) and split-K variants timed against each
    other at decode, serve, lfc8 and prefill shapes, each held bit for bit;
    these launches bypass the counted wrapper. Returns ms by shape and split
    count, and the planned variant."""
    from brevitas_tpu_torch.kernels.int_matmul import (
        int8_matmul_plan,
        int8_matmul_reference,
        launch_int8_matmul,
    )

    g = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for m, k, n in SPLIT_SHAPES:
        x = torch.randint(-128, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        w = torch.randint(-128, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        xs = torch.rand((), generator=g, device=dev) * 0.05 + 1e-3
        ws = torch.rand(n, generator=g, device=dev) * 0.05 + 1e-3
        b = torch.randn(n, generator=g, device=dev)
        want = int8_matmul_reference(x, w, xs, ws, b)
        times = {}
        for splits in SPLITS:
            got = launch_int8_matmul(x, w, xs, ws, b, splits=splits)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"int8_matmul with {splits} K splits differs from its "
                                     f"plain version at {(m, k, n)}")
            times[splits] = cuda_ms(lambda: launch_int8_matmul(x, w, xs, ws, b, splits=splits))
        plan = int8_matmul_plan(x, w)
        out[f"{m}x{k}x{n}"] = {"plan": plan, "ms_by_splits": times}
        print(f"[kernels] int8_matmul {m} {k} {n} forced K splits " + ", ".join(
            f"{sp}: {t:.4f} ms" for sp, t in times.items()) + f" | planned {plan}")
    return out


# int4_matmul at ragged shapes that reach every load path of its launcher:
# K/2 = 3, 392, 1 and 393 (odd: x by byte loads), N 10, 3 and 1000 (w by byte
# loads), ragged last tiles in M, N and K/2; each also forced tiled
INT4_EDGE_SHAPES = [(1, 6, 10), (37, 784, 1024), (5, 2, 3), (37, 786, 1024), (200, 2752, 1000)]
# one-hot probes: a K index in one nibble half, an N index in the other
INT4_PROBE_SHAPES = [(128, 512, 256), (16, 1024, 128)]
# every forced split count at the decode, edge and prefill shapes
INT4_SPLIT_SHAPES = [(16, 1024, 1024), (16, 2752, 1024), (37, 786, 1024), (200, 2752, 1000),
                     (4096, 1024, 1024)]


def int4_probe(dev, m, k, n):
    """Structural probes of int4_matmul: row r of x is one-hot at K index k_r,
    scales are 1 and there is no bias, so y[r, c] is exactly w[k_r, c]. The
    packed weights hold (index >> shift) % 16 - 8 of their packed row j in one
    nibble half and of their column c in the other, for shifts 0 and 4, both
    ways round: a wrong fragment, nibble or token mapping names the first
    output it breaks."""
    from brevitas_tpu_torch.kernels import int4_matmul, int4_matmul_reference

    k2 = k // 2
    rows = torch.arange(m, device=dev)
    k_of = (rows * (k // m) + rows % 7) % k  # every residue of a 32-row slab
    x = torch.zeros((m, k), dtype=torch.int8, device=dev)
    x[rows, k_of] = 1
    j = torch.arange(k2, device=dev).reshape(-1, 1).expand(k2, n)
    c = torch.arange(n, device=dev).reshape(1, -1).expand(k2, n)
    one, ones = torch.ones((), device=dev), torch.ones(n, device=dev)
    for shift in (0, 4):
        for lo, hi, what in ((j, c, "K index low, N index high"),
                             (c, j, "N index low, K index high")):
            wp = (((lo >> shift) & 15) | (((hi >> shift) & 15) << 4)).to(torch.int32)
            wp = torch.where(wp >= 128, wp - 256, wp).to(torch.int8).contiguous()
            got = int4_matmul(x, wp, one, ones)
            want = int4_matmul_reference(x, wp, one, ones)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = (got != want).nonzero()[0].tolist()
                raise AssertionError(
                    f"int4_matmul probe {(m, k, n)} ({what}, shift {shift}): y{tuple(bad)} = "
                    f"{float(got[bad[0], bad[1]])}, want {float(want[bad[0], bad[1]])} "
                    f"(x one-hot at K {int(k_of[bad[0]])})")
    print(f"[kernels] int4_matmul probe {m} {k} {n}: one-hot x, K and N indices in the "
          "nibbles, bit for bit")


def phase_int4_kernel(dev, peaks):
    """int4_matmul (W4A8): structural probes; then the Llama shapes and ragged
    ones, with and without bias, with ReLU, per-channel and scalar weight
    scales, bit for bit against its plain version (the ragged ones also
    forced tiled); the variant each shape takes; times. Returns the rows."""
    from brevitas_tpu_torch.kernels import int4_matmul, int4_matmul_reference, unpack_int4_rows
    from brevitas_tpu_torch.kernels.int4 import int4_matmul_plan, launch_int4_matmul

    bw, int8_peak, _ = peaks
    for m, k, n in INT4_PROBE_SHAPES:
        int4_probe(dev, m, k, n)
    g = torch.Generator(device=dev).manual_seed(2)
    rows = []
    print("[kernels] int4_matmul M K N variant | kernel_ms plain_ms library_ms(torch._int_mm "
          "on unpacked 8-bit weights, not the same function) bound_ms bound_by | max_abs_err "
          "| call_ms")
    shapes = INT4_EDGE_SHAPES + [(m, k, n) for m in LLAMA_M for k, n in LLAMA_KN]
    for m, k, n in shapes:
        x = torch.randint(-128, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        wp = torch.randint(-128, 128, (k // 2, n), generator=g, device=dev, dtype=torch.int8)
        xs = torch.rand((), generator=g, device=dev) * 0.05 + 1e-3
        ws = torch.rand(n, generator=g, device=dev) * 0.05 + 1e-3
        b = torch.randn(n, generator=g, device=dev)
        plan = int4_matmul_plan(x, wp)
        err = 0.0
        for w_scale, bias, act in ((ws, b, None), (ws, None, None), (ws, b, "relu"),
                                   (xs * 2, None, "relu"), (xs * 2, b, None)):
            got = int4_matmul(x, wp, xs, w_scale, bias, act=act)
            want = int4_matmul_reference(x, wp, xs, w_scale, bias, act=act)
            torch.cuda.synchronize()
            err = max(err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(
                    f"int4_matmul differs from its plain version at {(m, k, n)} {plan} "
                    f"act={act} bias={bias is not None} per-channel={w_scale is ws}: max {err}")
        if (m, k, n) in INT4_EDGE_SHAPES:
            got = launch_int4_matmul(x, wp, xs, ws, b, splits=1)
            torch.cuda.synchronize()
            if not torch.equal(got, int4_matmul_reference(x, wp, xs, ws, b)):
                raise AssertionError(f"int4_matmul forced tiled differs at {(m, k, n)}")
            print(f"[kernels] int4_matmul {m} {k} {n} {plan} | edge shape: bit for bit with "
                  "and without bias and ReLU, per-channel and scalar scales, and forced tiled")
            continue
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
                         library_ms=t_l, bound_ms=t_b, bound_by=by, err=err, call_ms=t_call,
                         variant=plan))
        print(f"[kernels] int4_matmul {m} {k} {n} {plan} | {t_k:.4f} {t_p:.4f} {lib} "
              f"{t_b:.3g} {by} | {err} | call {t_call:.4f}")
    return rows


def phase_int4_crossover(dev) -> dict:
    """int4_matmul's tiled (1 split) and split-K variants timed against each
    other at decode, edge and prefill shapes, each held bit for bit; these
    launches bypass the counted wrapper. Returns ms by shape and split count,
    and the planned variant."""
    from brevitas_tpu_torch.kernels import int4_matmul_reference
    from brevitas_tpu_torch.kernels.int4 import int4_matmul_plan, launch_int4_matmul

    g = torch.Generator(device=dev).manual_seed(4)
    out = {}
    for m, k, n in INT4_SPLIT_SHAPES:
        x = torch.randint(-128, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        wp = torch.randint(-128, 128, (k // 2, n), generator=g, device=dev, dtype=torch.int8)
        xs = torch.rand((), generator=g, device=dev) * 0.05 + 1e-3
        ws = torch.rand(n, generator=g, device=dev) * 0.05 + 1e-3
        b = torch.randn(n, generator=g, device=dev)
        want = int4_matmul_reference(x, wp, xs, ws, b)
        times = {}
        for splits in SPLITS:
            got = launch_int4_matmul(x, wp, xs, ws, b, splits=splits)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"int4_matmul with {splits} K splits differs from its "
                                     f"plain version at {(m, k, n)}")
            times[splits] = cuda_ms(lambda: launch_int4_matmul(x, wp, xs, ws, b, splits=splits))
        plan = int4_matmul_plan(x, wp)
        out[f"{m}x{k}x{n}"] = {"plan": plan, "ms_by_splits": times}
        print(f"[kernels] int4_matmul {m} {k} {n} forced K splits " + ", ".join(
            f"{sp}: {t:.4f} ms" for sp, t in times.items()) + f" | planned {plan}")
    return out


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
# (BH, l_half, D) at the given positions; the first rows are the main path's.
# The prefill edges: D 40 (byte loads, D padded to 64) with Tq > Tk (fully
# masked rows) and a ragged key tile; non-causal over a ragged Tk; Tq > Tk on
# TMA; D 256 and D 192 (four and three 64-column chunks, two 128-byte column
# blocks); D 96 and 4 query heads a KV head
ATTN_SHAPES = [(128, 512, 512, 64, True, 1), (6, 77, 45, 40, True, 2),
               (32, 200, 300, 64, False, 1), (8, 300, 100, 64, True, 1),
               (16, 256, 256, 256, True, 1), (8, 100, 130, 192, False, 2),
               (32, 128, 200, 96, True, 4)]
DECODE_SHAPE = (256, 512, 64)
DECODE_POS = [63, 0, 511, 1023]
# a ragged grouped-query decode shape (BH, l_half, D, kv_groups) at positions
# on both sides of l_half: its last low-nibble row, its first high one, the last
DECODE_RAGGED = (6, 77, 40, 2)
DECODE_RAGGED_POS = [0, 40, 76, 77, 153]
DECODE_SPLIT_POS = [63, 511, 1023]  # every forced cluster size at these positions
# and at a few heads over a long cache (BH, l_half, D): one sequence of 16
# heads at up to 32k positions
DECODE_FEW_HEADS = (16, 16384, 64)
DECODE_FEW_HEADS_POS = [127, 1023, 8191, 32767]
# decode shapes held to the plain version but not timed, (BH, l_half, D,
# kv_groups) at these positions: a cache long enough that a rank's chunk goes
# in several tiles and its scores to the scratch buffer, over a full cluster;
# 8 query heads a KV head over a cache where the planned rows a CTA drop
# from 8 to 1 near the end, so the scores go to scratch at mid positions
# only; and a head dim off the 4-byte word (byte loads)
DECODE_CHECKS = [((2, 262144, 8, 1), [262149, 524287]),
                 ((64, 80000, 64, 8), [40000, 159999]),
                 ((4, 37, 33, 2), [5, 36, 37, 73])]
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
    from brevitas_tpu_torch.kernels.int8_attention import (
        _decode_plan_code,
        _needs_scratch,
        int4kv_decode_attention_plan,
        int4kv_decode_scales,
        int8_attention_plan,
        int8_attention_plan_code,
        launch_int4kv_decode_attention,
    )

    bw, int8_peak, _ = peaks
    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    print("[attn] kernel shape | kernel_ms plain_ms library_ms(bf16 SDPA, not the same "
          "function) bound_ms bound_by | code flips, max_abs_err (decode: kernel_ms the "
          "counted call's device time, scale arithmetic included)")
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
        plan = int8_attention_plan(q, k, v)
        if plan != int8_attention_plan_code(q, k, v):
            raise AssertionError(f"int8_attention_plan says {plan!r}, the launcher "
                                 f"{int8_attention_plan_code(q, k, v)!r}")
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
        rows.append(dict(kernel="int8_attention", shape=(bh, tq, tk, d), causal=causal,
                         groups=groups, variant=plan, ms=t_k, plain_ms=t_p, library_ms=t_l,
                         bound_ms=t_b, bound_by=by, err=err, flips=flips,
                         codes=got_codes.numel()))
        print(f"[attn] int8_attention {(bh, tq, tk, d)} causal={causal} groups={groups} "
              f"{plan} | {t_k:.4f} {t_p:.4f} {t_l:.4f} {t_b:.4g} {by} | {flips} of "
              f"{got_codes.numel()}, {err:.3g}")

    q_s = torch.tensor(0.01, device=dev)
    ps, vs = torch.tensor(0.25 / 255, device=dev), torch.tensor(0.1, device=dev)
    for (bh, l_half, d), groups, positions in ((DECODE_SHAPE, 1, DECODE_POS),
                                               (DECODE_RAGGED[:3], DECODE_RAGGED[3],
                                                DECODE_RAGGED_POS)):
        q = torch.randint(-127, 128, (bh, 1, d), generator=g, device=dev, dtype=torch.int8)
        kp, vp = (torch.randint(-128, 128, (bh // groups, l_half, d), generator=g, device=dev,
                                dtype=torch.int8) for _ in range(2))
        # q codes ~ 73 and nibbles ~ 4.6 in standard deviation: scores of deviation ~3
        k_s = torch.tensor(3.0 / (73 * 4.6 * 0.01 * (d / 64) ** 0.5), device=dev)
        k_full, v_full = (unpack_kv_halves(t).repeat_interleave(groups, 0) for t in (kp, vp))
        for pos in positions:
            args = (pos, q_s, k_s, vs, ps, d)
            kw = dict(kv_groups=groups)
            plan = int4kv_decode_attention_plan(q, kp, pos, groups)
            got, got_codes = int4kv_decode_attention(q, kp, vp, *args, return_codes=True, **kw)
            want, want_codes = int4kv_decode_attention_reference(q, kp, vp, *args,
                                                                 return_codes=True, **kw)
            torch.cuda.synchronize()
            what = f"int4kv_decode_attention {(bh, l_half, d)} groups={groups} pos={pos}"
            flips, err = check_codes(got, got_codes, want, want_codes, v_full, ps * vs, what)
            # the counted call's device time, as every kernel row is timed:
            # the wrapper's scale arithmetic (three small torch kernels) and
            # the kernel; then the kernel alone, on scales made once
            t_call = cuda_ms(lambda: int4kv_decode_attention(q, kp, vp, *args, **kw))
            sc = int4kv_decode_scales(q_s, k_s, vs, ps, d, dev)
            t_k = cuda_ms(lambda: launch_int4kv_decode_attention(q, kp, vp, pos, sc, **kw))
            t_p = cuda_ms(lambda: int4kv_decode_attention_reference(q, kp, vp, *args, **kw))
            qb = q.to(torch.bfloat16)[None]
            kb = k_full[None, :, :pos + 1].to(torch.bfloat16)
            vb = v_full[None, :, :pos + 1].to(torch.bfloat16)
            t_l = cuda_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb))
            n_rows = min(l_half, pos + 1)
            nbytes = bh * d + 2 * (bh // groups) * n_rows * d + 4 * bh * d + 12
            t_b, by = bound(nbytes, 4.0 * bh * (pos + 1) * d, bw, int8_peak)
            rows.append(dict(kernel="int4kv_decode_attention", shape=(bh, l_half, d),
                             groups=groups, pos=pos, ms=t_call, kernel_only_ms=t_k,
                             plain_ms=t_p, library_ms=t_l, bound_ms=t_b, bound_by=by,
                             err=err, flips=flips, variant=plan))
            print(f"[attn] int4kv_decode_attention {(bh, l_half, d)} groups={groups} "
                  f"pos={pos} {plan} | {t_call:.4f} (kernel alone {t_k:.4f}) {t_p:.4f} "
                  f"{t_l:.4f} {t_b:.4g} {by} | {flips} of {got_codes.numel()}, {err:.3g}")
        if groups == 1:
            rows[-1]["split_crossover"] = {
                "x".join(map(str, DECODE_SHAPE)): decode_crossover(
                    q, kp, vp, q_s, k_s, vs, ps, v_full, DECODE_SPLIT_POS)}

    # few heads over a long cache: the CTAs leave most SMs idle, the case the
    # launcher's cluster split is for
    bh, l_half, d = DECODE_FEW_HEADS
    q = torch.randint(-127, 128, (bh, 1, d), generator=g, device=dev, dtype=torch.int8)
    kp, vp = (torch.randint(-128, 128, (bh, l_half, d), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    k_s = torch.tensor(3.0 / (73 * 4.6 * 0.01 * (d / 64) ** 0.5), device=dev)
    next(r for r in rows if "split_crossover" in r)["split_crossover"][
        "x".join(map(str, DECODE_FEW_HEADS))] = decode_crossover(
            q, kp, vp, q_s, k_s, vs, ps, unpack_kv_halves(vp), DECODE_FEW_HEADS_POS)

    for (bh, l_half, d, groups), positions in DECODE_CHECKS:
        q = torch.randint(-127, 128, (bh, 1, d), generator=g, device=dev, dtype=torch.int8)
        kp, vp = (torch.randint(-128, 128, (bh // groups, l_half, d), generator=g, device=dev,
                                dtype=torch.int8) for _ in range(2))
        # scores of deviation ~9: over 2^19 positions some codes stay above 0
        k_s = torch.tensor(9.0 / (73 * 4.6 * 0.01 * (d / 64) ** 0.5), device=dev)
        v_full = unpack_kv_halves(vp).repeat_interleave(groups, 0)
        # the wrapper allocates the scratch buffer once for the shape: every
        # position whose plan keeps the scores there must find it
        spill = [p for p in range(2 * l_half)
                 if _decode_plan_code(bh, l_half, d, groups, p) >> 16 & 1]
        if spill and not _needs_scratch(bh, l_half, d, groups):
            raise AssertionError(f"int4kv_decode_attention {(bh, l_half, d)} groups={groups}: "
                                 f"{len(spill)} positions plan scratch, the wrapper has none")
        print(f"[attn] int4kv_decode_attention {(bh, l_half, d)} groups={groups}: "
              f"{len(spill)} of {2 * l_half} positions keep the scores in scratch"
              + (f" (first {spill[0]}, last {spill[-1]})" if spill else ""))
        for pos in positions:
            args = (pos, q_s, k_s, vs, ps, d)
            plan = int4kv_decode_attention_plan(q, kp, pos, groups)
            got, got_codes = int4kv_decode_attention(q, kp, vp, *args, return_codes=True,
                                                     kv_groups=groups)
            want, want_codes = int4kv_decode_attention_reference(
                q, kp, vp, *args, return_codes=True, kv_groups=groups)
            torch.cuda.synchronize()
            what = f"int4kv_decode_attention {(bh, l_half, d)} groups={groups} pos={pos}"
            flips, err = check_codes(got, got_codes, want, want_codes, v_full, ps * vs, what)
            print(f"[attn] {what} {plan} | checked, not timed: {flips} of "
                  f"{got_codes.numel()} codes differ, max |diff| {err:.3g}")
    return rows


def decode_crossover(q, kp, vp, q_s, k_s, vs, ps, v_full, positions) -> dict:
    """int4kv_decode_attention at every forced cluster size at ``positions``,
    each held to the plain version by check_codes and timed alone on scales
    made once (the splits differ only in the kernel); these launches bypass
    the counted wrapper. Returns the kernel's ms by position and split."""
    from brevitas_tpu_torch.kernels import int4kv_decode_attention_reference
    from brevitas_tpu_torch.kernels.int8_attention import (
        int4kv_decode_attention_plan,
        int4kv_decode_scales,
        launch_int4kv_decode_attention,
    )

    d = q.shape[-1]
    sc = int4kv_decode_scales(q_s, k_s, vs, ps, d, q.device)
    out = {}
    for pos in positions:
        want, want_codes = int4kv_decode_attention_reference(q, kp, vp, pos, q_s, k_s, vs, ps,
                                                             d, return_codes=True)
        times = {}
        for splits in SPLITS:
            got, got_codes = launch_int4kv_decode_attention(q, kp, vp, pos, sc,
                                                            return_codes=True, splits=splits)
            torch.cuda.synchronize()
            check_codes(got, got_codes, want, want_codes, v_full, ps * vs,
                        f"int4kv_decode_attention pos={pos} with {splits} forced splits")
            times[splits] = cuda_ms(
                lambda: launch_int4kv_decode_attention(q, kp, vp, pos, sc, splits=splits))
        plan = int4kv_decode_attention_plan(q, kp, pos)
        out[str(pos)] = {"plan": plan, "ms_by_splits": times}
        print(f"[attn] int4kv_decode_attention {tuple(kp.shape)} pos={pos} forced splits, "
              "the kernel alone: "
              + ", ".join(f"{sp}: {t:.4f} ms" for sp, t in times.items())
              + f" | planned {plan}")
    return out


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
    _record_path("serve", counts)
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
        _record_path(f"lfc{bits}", counts)
        print(f"[lfc] {bits}-bit batch {LFC_BATCH}: launches {counts}")
        # 4 GEMM launches, and 4 fake_quant: the input and 3 activation quantizers
        want = {k: 4 if k in (kernel, "fake_quant") else 0 for k in counts}
        if counts != want:
            raise AssertionError(f"lfc {bits}-bit: expected launches {want}")
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
            "int4kv_decode_attention": K.int4kv_decode_attention.launches,
            "quant_lstm_cell": K.quant_lstm_cell.launches,
            "quant_lstm_cell_backward": K.quant_lstm_cell_backward.launches,
            "quant_lstm_cell_tables": K.quant_lstm_cell_tables.launches,
            "fake_quant": K.fake_quant.launches,
            "fake_quant_backward": K.fake_quant_backward.launches}


# every kernel's launches on each main path, as each phase read them
PATH_COUNTS = {}


def _record_path(path: str, counts: dict) -> None:
    PATH_COUNTS[path] = dict(counts)


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


def profile_steps(fn, what: str, unit: str, n: int = 3, grad: bool = False) -> dict:
    """Device busy time by kernel from torch.profiler over ``n`` calls of
    ``fn`` (each ending in a synchronize), beside their wall time; the rest
    of the wall time the card is idle. ``grad``: ``fn`` is a training step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with contextlib.nullcontext() if grad else torch.no_grad():
        fn()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
              and not e.key.startswith("Activity Buffer")]
    rows = [(e.key, e.self_device_time_total / 1e3 / n) for e in events]
    busy_ms = sum(t for _, t in rows)
    launches = sum(e.count for e in events) / n
    top = sorted(rows, key=lambda r: -r[1])[:8]
    print(f"[{what}] profile per {unit}: device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms "
          f"wall under the profiler (idle share {1 - busy_ms / wall_ms:.3f}), {launches:g} "
          f"device activities; top device ms: "
          + ", ".join(f"{k[:48]} {t:.4f}" for k, t in top))
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "idle_share": 1 - busy_ms / wall_ms,
            "device_activities": launches, "top": [(k[:64], t) for k, t in top]}


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
    _record_path(what, counts)
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
    _record_path(what, counts)
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
        _record_path(what, counts)
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


# bench.py's quantlstm_int8_qat leg (bench.py:427-491): QuantLSTM(128, 512,
# num_layers=2) and a Linear(512, 10) head on y[:, -1], batch 64, sequence 64
LSTM_LEG = dict(feat=128, hidden=512, layers=2, batch=64, seq=64)
LSTM_TIMED_STEPS = 5
LSTM_LR = 1e-3
# (B, H) of the cell kernels' checks: the leg's, two off the forward's
# 256-thread blocks (101 also off the backward's 4 columns a CTA), and a
# batch past a backward CTA's 64 row lanes (each thread takes 16 rows)
LSTM_KERNEL_SHAPES = [(64, 512), (3, 100), (3, 101), (1024, 512)]
# how sa and ss come: one per column (4H, 3H: the forward's direct chain),
# one per gate block (4, 3: the leg's per-tensor gate quantizers, as
# QuantLSTM passes them) or one value (both also on the stage tables);
# every form at every shape
LSTM_SCALE_FORMS = ("column", "gate", "one")
# the forward's table rule, C against Python: (sa_gate, sa_col, ss_gate,
# ss_col, acc lo, hi, cell lo, hi) at every stride form and the code-range
# limits (1024 codes, +-2^24, ordered)
LSTM_TABLE_PLAN_CASES = [
    (1, 0, 1, 0, -128, 127, -128, 127), (0, 0, 0, 0, -128, 127, -128, 127),
    (0, 0, 1, 0, 0, 0, 0, 0), (512, 1, 1, 0, -128, 127, -128, 127),
    (1, 0, 512, 1, -128, 127, -128, 127), (1, 0, 1, 0, -512, 511, -8, 7),
    (1, 0, 1, 0, -512, 512, -8, 7), (1, 0, 1, 0, -8, 7, 0, 1024), (1, 0, 1, 0, 5, 4, -8, 7),
    (1, 0, 1, 0, 2**24 - 9, 2**24, -8, 7), (1, 0, 1, 0, -8, 7, 2**24 - 9, 2**24 + 1),
    (1, 0, 1, 0, -2**24 - 1, -2**24 + 8, -8, 7)]
# bytes a (b, j) element of the forward: the one-tensor form reads gates and
# c and writes h and c'; the two-addend form reads xp (float32 or bf16), p
# and c and writes gates, h and c'
LSTM_FWD_BYTES = {"direct": 28, "tables": 28, "add_f32": 60, "add_bf16": 52}
# the leg's six stages (acc, sigmoid, tanh_g, cell, tanh_h, hidden): int8,
# the sigmoid uint8
LSTM_BOUNDS = ((-128, 127), (0, 255), (-128, 127), (-128, 127), (-128, 127), (-128, 127))
LSTM_SCALE_SUM_RTOL = 1e-5  # of sum |term|, against the float64 sum of the terms
LSTM_LOSS_RTOL = 1e-3       # kernel path against module cell, each step's loss
LSTM_UPDATE_RTOL = 0.3      # |update difference| / |update| of each weight
LSTM_CELL_SCALE_GRAD_RTOL = 1e-4  # of the largest cell-scale gradient, first step
# bf16 operands, first step, weights and cell scales: four bf16 steps of the
# largest element. The per-step product's operand gradients are rounded to
# bf16 (dh into the cell, W_hh's gradient), so where the kernel's backward and
# autograd's differ in their float32 last bits that rounding falls either way,
# a bf16 step (2^-8 of the value), and W_hh's gradient is summed over the 64
# time steps in bf16, re-rounded at each addition (6.9e-3 for W_hh on an H100)
LSTM_BF16_GRAD_RTOL = 2.0 ** -6
# fake_quant launches a QAT step, each way: per layer the input quantizer and
# the 4 + 4 per-gate weight quantizers of w_ih and w_hh
LSTM_FQ_PER_STEP = LSTM_LEG["layers"] * 9


def lstm_cell_inputs(dev, b: int, h: int, seed: int, form: str = "column"):
    """Gates, state, scales and upstream gradients of one cell step, drawn so
    that every stage's clamp is reached: |gates| beyond 127 * sa, 255 * ss
    and 127 * st below 1, |f c + i g| beyond 127 * sc, 127 * sth below 1,
    127 * sh below the largest o * th. ``form``: how many values sa and ss
    have (LSTM_SCALE_FORMS). With few values (one per gate block, or one)
    every clamp is reached at any shape: sigmoid(127 sa) > 255 ss, and
    element (0, 0) has every gate and its state beyond their clamps, so
    that o th > 127 sh there; and row 1's gates lie within 3 ulps of a
    rounding tie of the acc stage (gates / sa = k + 1/2), where a code
    formed otherwise than by the plain version's division would differ."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    gates = torch.randn((b, 4 * h), generator=g, device=dev) * 4
    c = torch.randn((b, h), generator=g, device=dev) * 2
    n_sa, n_ss = {"column": (4 * h, 3 * h), "gate": (4, 3), "one": (1, 1)}[form]
    few = n_ss <= 3
    # a few ss all below 1 / 255: the sigmoid's top clamp is reached
    scales = (uniform(n_sa, 0.03 if few else 0.01, 0.05),
              uniform(n_ss, 0.003 if few else 0.002, 0.0038 if few else 0.006),
              *(torch.tensor(v, device=dev) for v in (0.005, 0.015, 0.005, 0.003)))
    if few:
        gates[0, ::h] = 1e3
        c[0, 0] = 10.0
        if b > 1:
            cols = torch.arange(4 * h, device=dev)
            tie = (cols % 201 - 100 + 0.5) * scales[0].repeat_interleave(4 * h // n_sa)
            ulps = cols % 7 - 3
            for step in range(3):
                tie = torch.where(ulps > step, torch.nextafter(tie, tie + 1), tie)
                tie = torch.where(-ulps > step, torch.nextafter(tie, tie - 1), tie)
            gates[1] = tie
    dh = torch.randn((b, h), generator=g, device=dev)
    dcn = torch.randn((b, h), generator=g, device=dev)
    return gates, c, scales, dh, dcn


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal to the bit (the sign of zero counts), NaN where NaN."""
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and torch.equal(torch.where(nan, 0.0, a).view(torch.int32),
                            torch.where(nan, 0.0, b).view(torch.int32)))


def check_table_plan(planner) -> None:
    """The forward's table rule in Python against the launcher's."""
    from brevitas_tpu_torch.kernels.lstm_cell import quant_lstm_cell_table_plan

    for case in LSTM_TABLE_PLAN_CASES:
        if quant_lstm_cell_table_plan(*case) != planner(*case):
            raise AssertionError(f"quant_lstm_cell_table_plan{case} = "
                                 f"{quant_lstm_cell_table_plan(*case)}, the launcher "
                                 f"{planner(*case)}")
    print(f"[lstm_kernels] the table rule in Python equals the launcher's at "
          f"{len(LSTM_TABLE_PLAN_CASES)} cases")


def check_two_addend(args, tables, g, what: str) -> dict:
    """The two-addend forward (gates = xp + p, formed and written by the
    kernel) on a strided float32 step of a (B, 3, 4H) projection, on bf16
    copies of it (contiguous and strided), against torch's add and the plain
    version on it: the gates, h and c' bit for bit. Its gradients to xp (in
    xp's dtype) and p against the one-tensor kernel's through ``.to()`` and
    ``+``, bit for bit. Returns the addends for timing."""
    from brevitas_tpu_torch.kernels import quant_lstm_cell, quant_lstm_cell_reference
    from brevitas_tpu_torch.kernels.lstm_cell import _forward_kernel

    gates, c, *scales = args
    b, n = gates.shape
    x_all = torch.randn((b, 3, n), generator=g, device=gates.device) * 3
    p = gates - x_all[:, 1]
    addends = {"add_f32": x_all.unbind(1)[1], "add_bf16": x_all[:, 1].to(torch.bfloat16),
               "add_bf16_strided": x_all.to(torch.bfloat16).unbind(1)[1]}
    for name, xp in addends.items():
        with torch.no_grad():
            got = _forward_kernel(xp, p, c, *scales, LSTM_BOUNDS, tables)
            want_g = xp.to(torch.float32) + p
            want = (want_g, *quant_lstm_cell_reference(want_g, c, *scales, LSTM_BOUNDS))
        torch.cuda.synchronize()
        for part, x, y in zip(("gates", "h", "c_new"), got, want):
            if not same_bits(x, y):
                raise AssertionError(f"quant_lstm_cell two addends ({name}) {part} at {what}: "
                                     f"{int((x != y).sum())} of {y.numel()} differ")
    dh, dcn = (torch.randn(c.shape, generator=g, device=gates.device) for _ in range(2))
    for name in ("add_f32", "add_bf16_strided"):
        runs = []
        for two in (True, False):
            leaf = x_all.to(torch.bfloat16) if name == "add_bf16_strided" else x_all.clone()
            leaf.requires_grad_()
            pl = p.clone().requires_grad_()
            xp = leaf.unbind(1)[1]
            if two:
                out = quant_lstm_cell(xp, c, *scales, LSTM_BOUNDS, recurrent=pl, tables=tables)
            else:
                out = quant_lstm_cell(xp.to(torch.float32) + pl, c, *scales, LSTM_BOUNDS,
                                      tables=tables)
            torch.autograd.backward(out, (dh, dcn))
            runs.append((leaf.grad.float(), pl.grad))
        torch.cuda.synchronize()
        if not all(same_bits(x, y) for x, y in zip(*runs)):
            raise AssertionError(f"quant_lstm_cell two addends ({name}): gradients differ from "
                                 f"the one-tensor kernel's through .to() and + at {what}")
    return {"add_f32": addends["add_f32"], "add_bf16": addends["add_bf16_strided"], "p": p}


def phase_lstm_kernels(dev, vector_peaks, bw) -> list:
    """quant_lstm_cell's forward (direct chain, stage tables, two addends),
    its table build and its backward against their plain versions on the
    card, and timed. Returns one row per (kernel, path, shape, scales)."""
    from brevitas_tpu_torch.kernels import (
        quant_lstm_cell,
        quant_lstm_cell_backward,
        quant_lstm_cell_backward_reference,
        quant_lstm_cell_reference,
        quant_lstm_cell_tables,
        quant_lstm_cell_tables_reference,
    )
    from brevitas_tpu_torch.kernels import _launch
    from brevitas_tpu_torch.kernels.lstm_cell import (
        quant_lstm_cell_backward_plan,
        quant_lstm_cell_scale_terms,
    )

    f32_peak, f64_peak = vector_peaks
    rows = []
    planner = _launch.bind_ints("quant_lstm_cell", "quant_lstm_cell_backward_plan", 1)
    check_table_plan(_launch.bind_ints("quant_lstm_cell", "quant_lstm_cell_table_plan", 8))
    print("[lstm_kernels] kernel path B H scales | kernel_ms plain_ms bound_ms bound_by | "
          "max_abs_err | checks (no PyTorch call computes this function: library_ms null)")
    cases = [(b, h, form) for b, h in LSTM_KERNEL_SHAPES for form in LSTM_SCALE_FORMS]
    for b, h, form in cases:
        if quant_lstm_cell_backward_plan(b) != planner(b):
            raise AssertionError(f"quant_lstm_cell_backward_plan({b}) = "
                                 f"{quant_lstm_cell_backward_plan(b)}, the launcher {planner(b)}")
        gates, c, scales, dh, dcn = lstm_cell_inputs(dev, b, h, seed=b * h, form=form)
        args = (gates, c, *scales)
        # the plain version's per-element scale-gradient terms, and each
        # stage's values before rounding
        terms, _, pre, fwd = quant_lstm_cell_scale_terms(*args, dh, dcn, LSTM_BOUNDS)
        shares = [float(((torch.round(x) < lo) | (torch.round(x) > hi)).float().mean())
                  for x, (lo, hi) in zip(pre, LSTM_BOUNDS)]
        if min(shares) == 0:
            raise AssertionError(f"lstm_kernels: a clamp is never reached at {(b, h)}: {shares}")
        # the stage tables: None for scales per column (the direct chain)
        built = quant_lstm_cell_tables.launches
        tables = quant_lstm_cell_tables(*scales[:5], LSTM_BOUNDS)
        if (tables is None) != (form == "column"):
            raise AssertionError(f"lstm_kernels: tables {tables is not None} at {form}")
        if tables is not None:
            want_tables = quant_lstm_cell_tables_reference(*scales[:5], LSTM_BOUNDS)
            torch.cuda.synchronize()
            if quant_lstm_cell_tables.launches - built != 1:
                raise AssertionError("quant_lstm_cell_tables: not one launch a call")
            if not same_bits(tables, want_tables):
                raise AssertionError(f"quant_lstm_cell_tables differ from the plain tables at "
                                     f"{form}: {int((tables != want_tables).sum())} slots")
        with torch.no_grad():
            h_r, c_r = quant_lstm_cell_reference(*args, LSTM_BOUNDS)
            paths = {"direct": quant_lstm_cell(*args, LSTM_BOUNDS)}
            if tables is not None:
                paths["tables"] = quant_lstm_cell(*args, LSTM_BOUNDS, tables=tables)
        torch.cuda.synchronize()
        for path, (h_k, c_k) in paths.items():
            if not (torch.equal(h_k, h_r) and torch.equal(c_k, c_r)):
                raise AssertionError(
                    f"quant_lstm_cell ({path}) differs from its plain version at {(b, h)} "
                    f"{form}: h {int((h_k != h_r).sum())}, c_new {int((c_k != c_r).sum())} of "
                    f"{h_r.numel()}")
        fwd_err = max(max(float((h_k - h_r).abs().max()), float((c_k - c_r).abs().max()))
                      for h_k, c_k in paths.values())
        g = torch.Generator(device=dev).manual_seed(b * h + 1)
        addends = check_two_addend(args, tables, g, f"{(b, h)} {form}")

        launched = quant_lstm_cell_backward.launches
        got = quant_lstm_cell_backward(*args, dh, dcn, LSTM_BOUNDS)
        again = quant_lstm_cell_backward(*args, dh, dcn, LSTM_BOUNDS)
        if quant_lstm_cell_backward.launches - launched != 2:
            raise AssertionError("quant_lstm_cell_backward: not one launch a call")
        want = quant_lstm_cell_backward_reference(*args, dh, dcn, LSTM_BOUNDS)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"quant_lstm_cell_backward: two runs differ at {(b, h)} "
                                 f"{form}")
        if any(k_.shape != r_.shape for k_, r_ in zip(got, want)):
            raise AssertionError(f"quant_lstm_cell_backward: gradient shapes at {form}")
        for name, k_, r_ in (("dgates", got[0], want[0]), ("dc", got[1], want[1])):
            if not torch.allclose(k_, r_, rtol=1e-5, atol=1e-6):
                raise AssertionError(f"quant_lstm_cell_backward {name} at {(b, h)} {form}: "
                                     f"max {float((k_ - r_).abs().max())}")
        bwd_err = max(float((k_ - r_).abs().max()) for k_, r_ in zip(got[:2], want[:2]))
        # each scale's gradient against the float64 sum of those terms
        if not (torch.equal(fwd[0], h_r) and torch.equal(fwd[1], c_r)):
            raise AssertionError("lstm_kernels: the staged plain forward differs")
        worst = worst_plain = 0.0
        for name, k_, r_, t_ in zip(("dsa", "dss", "dst", "dsc", "dsth", "dsh"),
                                    got[2:], want[2:], terms):
            # a scale's terms summed over the elements that share it: the
            # batch (per column), the batch and a gate block's columns, or all
            n = k_.numel()
            t3 = t_.reshape(t_.shape[0], n, -1) if n > 1 else t_.reshape(t_.shape[0], 1, -1)
            exact, mass = t3.sum((0, 2)), t3.abs().sum((0, 2))
            dev_k = (k_.double().reshape(exact.shape) - exact).abs()
            dev_r = (r_.double().reshape(exact.shape) - exact).abs()
            ratio = float((dev_k / mass.clamp_min(1e-300)).max())
            worst = max(worst, ratio)
            worst_plain = max(worst_plain, float((dev_r / mass.clamp_min(1e-300)).max()))
            if not bool((dev_k <= LSTM_SCALE_SUM_RTOL * mass).all()):
                raise AssertionError(f"quant_lstm_cell_backward {name} at {(b, h)} {form}: "
                                     f"|kernel - f64| / sum|term| = {ratio:.3g}")
        print(f"[lstm_kernels] ({b}, {h}) scales per {form}: forward bit for bit on "
              f"{' and '.join(paths)} and with two addends (strided float32, bf16: gates, h, "
              f"c', gradients){', tables bit for bit' if tables is not None else ''}; "
              f"backward {quant_lstm_cell_backward_plan(b)} rows a thread, dgates/dc max "
              f"|diff| {bwd_err:.3g}, scale sums max |kernel - f64| / sum|term| {worst:.3g} "
              f"(plain version {worst_plain:.3g}), same bits on a second run; clamped shares "
              f"per stage {[round(x, 4) for x in shares]}")

        p = addends["p"]
        times = {}
        with torch.no_grad():
            times["direct"] = (cuda_ms(lambda: quant_lstm_cell(*args, LSTM_BOUNDS)),
                               cuda_ms(lambda: quant_lstm_cell_reference(*args, LSTM_BOUNDS)))
            if tables is not None:
                times["tables"] = (
                    cuda_ms(lambda: quant_lstm_cell(*args, LSTM_BOUNDS, tables=tables)),
                    times["direct"][1])
            for path in ("add_f32", "add_bf16"):
                xp = addends[path]
                times[path] = (
                    cuda_ms(lambda: quant_lstm_cell(xp, c, *scales, LSTM_BOUNDS, recurrent=p,
                                                    tables=tables)),
                    cuda_ms(lambda: quant_lstm_cell_reference(xp.to(torch.float32) + p, c,
                                                              *scales, LSTM_BOUNDS)))
            if tables is not None:
                times["build"] = (
                    cuda_ms(lambda: quant_lstm_cell_tables(*scales[:5], LSTM_BOUNDS)),
                    cuda_ms(lambda: quant_lstm_cell_tables_reference(*scales[:5], LSTM_BOUNDS)))
        t_bk = cuda_ms(lambda: quant_lstm_cell_backward(*args, dh, dcn, LSTM_BOUNDS))
        t_bp = cuda_ms(lambda: quant_lstm_cell_backward_reference(*args, dh, dcn, LSTM_BOUNDS))
        el, n_scales = b * h, scales[0].numel() + scales[1].numel() + 4
        # bytes: each input read once, each output written once; operations
        # per element as written (the direct chain: 7 stages of divide,
        # round, multiply and 4 products or sums in float32, 3 sigmoids of
        # exp, add and reciprocal and 2 tanh in float64; with the tables 6
        # stages' divide, round and clamp, 3 products and a sum, and no
        # float64; the add one more; the backward recomputes the direct
        # chain and adds about as many again). The table build: its slots
        # written, each formed as the direct chain forms its stage.
        n_slots = tables.numel() if tables is not None else 0
        items = [("quant_lstm_cell", path, t_k, t_p,
                  LSTM_FWD_BYTES[path] * el + 4 * n_scales
                  + (4 * n_slots if path != "direct" else 0),
                  26 if path.startswith("add") else 25,
                  11 if path == "direct" or tables is None else 0, fwd_err)
                 for path, (t_k, t_p) in times.items() if path != "build"]
        if tables is not None:
            items.append(("quant_lstm_cell_tables", "build", *times["build"],
                          4 * (n_slots + n_scales), 4 * n_slots / max(el, 1),
                          3 * n_slots / max(el, 1), 0.0))
        items.append(("quant_lstm_cell_backward", "direct", t_bk, t_bp,
                      4 * (12 * el + 2 * n_scales), 70, 22, bwd_err))
        for name, path, t_k, t_p, nbytes, n32, n64, err in items:
            t_bytes = nbytes / bw * 1e3
            t_ops = el * (n32 / f32_peak + n64 / f64_peak) * 1e3
            t_b, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            rows.append(dict(kernel=name, path=path, b=b, h=h, scales=form, ms=t_k,
                             plain_ms=t_p, bound_ms=t_b, bound_by=by, err=err, bytes=nbytes,
                             scale_sum_ratio=worst))
            print(f"[lstm_kernels] {name} {path} {b} {h} {form} | {t_k:.5f} {t_p:.4f} "
                  f"{t_b:.3g} {by} | {err:.3g}")
    return rows


def check_scale_routing(dev, layer) -> float:
    """The backward kernel's scale gradients routed to one layer's learned
    scales (``_QuantLSTMCell.backward``, ``_grad_like`` and the stack of the
    4 accumulator and 3 sigmoid gate scales, one per gate block, as the
    layer's ``_fused_cell_params`` builds them): one cell step on the
    card at the leg's shape, against the float64 sum of the plain version's
    terms over each scale's block, within LSTM_SCALE_SUM_RTOL of the terms'
    sum of magnitudes (the kernel rows' bound; the kernel sums each gate
    block in float64 and rounds once). A scale
    fed the wrong gate's sum misses it by the size of a gate's gradient.
    Returns the largest |grad - f64| / sum |term|, both taken to the
    parameter through the quantizer's own d scale / d parameter."""
    from brevitas_tpu_torch.kernels import quant_lstm_cell
    from brevitas_tpu_torch.kernels.lstm_cell import quant_lstm_cell_scale_terms

    h = layer.hidden_size
    gates, c, _, dh, dcn = lstm_cell_inputs(dev, LSTM_LEG["batch"], h, seed=h + 1)
    names = (("gate_acc", "forget_acc", "cell_acc", "out_acc"),  # gate blocks i, f, g, o
             ("in_sigmoid", "forget_sigmoid", "out_sigmoid"),   # i, f, o
             ("cell_tanh",), ("cell_state",), ("hidden_tanh",), ("hidden_state",))
    params = [[getattr(layer.quants, n).scaling.value for n in group] for group in names]
    for group in params:
        for p in group:
            p.grad = None
    sa, ss, scalars, bounds = layer._kernel_cell_args(layer._fused_cell_params(),
                                                      torch.float32)
    torch.autograd.backward(quant_lstm_cell(gates, c, sa, ss, *scalars, bounds), (dh, dcn))
    terms = quant_lstm_cell_scale_terms(gates, c, sa.detach(), ss.detach(),
                                        *(x.detach() for x in scalars), dh, dcn, bounds)[0]
    worst = 0.0
    for term, group, group_names in zip(terms, params, names):
        for g, (p, name) in enumerate(zip(group, group_names)):
            block = term[:, g * h:(g + 1) * h] if len(group) > 1 else term
            # d scale / d parameter of the quantizer's own scale function
            # (the parameter is the threshold: scale = threshold / 2^(b-1))
            scale = getattr(layer.quants, name).static_int_params()[0]
            (dsdp,) = torch.autograd.grad(scale.sum(), p)
            dsdp = dsdp.double().reshape(())
            ratio = float((p.grad.double().reshape(()) - block.sum() * dsdp).abs()
                          / (block.abs().sum() * dsdp.abs()).clamp_min(1e-300))
            worst = max(worst, ratio)
            if ratio > LSTM_SCALE_SUM_RTOL:
                raise AssertionError(f"lstm_qat: the gradient of {name}'s scale misses its "
                                     f"block's sum by {ratio:.3g} of sum |term|")
            p.grad = None
    return worst


class LSTMModel(torch.nn.Module):
    """bench.py's quantlstm_int8_qat model: QuantLSTM with the leg's
    quantizers (8-bit activations, the sigmoids unsigned, statistics
    collected for one step) and a Linear head on the last step's output."""

    def __init__(self, dev, generator: torch.Generator):
        from brevitas_tpu_torch.nn import QuantLSTM
        from brevitas_tpu_torch.quant import presets

        super().__init__()
        act = presets.Int8ActPerTensorFloat.let(collect_stats_steps=1)
        uact = presets.Uint8ActPerTensorFloat.let(collect_stats_steps=1)
        hidden = LSTM_LEG["hidden"]
        self.lstm = QuantLSTM(LSTM_LEG["feat"], hidden, num_layers=LSTM_LEG["layers"],
                              io_quant=act, gate_acc_quant=act, sigmoid_quant=uact,
                              tanh_quant=act, cell_state_quant=act, generator=generator,
                              device=dev)
        self.head = torch.nn.Linear(hidden, 10, device=dev)
        with torch.no_grad():  # nnx.Linear's init: lecun-normal kernel, zero bias
            self.head.weight.copy_(torch.randn((10, hidden), generator=generator)
                                   / hidden ** 0.5)
            self.head.bias.zero_()

    def forward(self, x):
        y, _ = self.lstm(x)
        return self.head(y[:, -1])


def lstm_train_step(model):
    """An Adam step (lr 1e-3, every parameter) on softmax cross-entropy."""
    opt = torch.optim.Adam(model.parameters(), lr=LSTM_LR)

    def step(x, y):
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


@contextlib.contextmanager
def plain_lstm_cell():
    """QuantLSTM's fused step on the cell's plain version (autograd through
    the plain chain, on ``xp.float() + p``) instead of the cell kernels, and
    no stage tables."""
    from brevitas_tpu_torch.kernels import quant_lstm_cell_reference
    from brevitas_tpu_torch.nn import rnn

    def plain(xp, c, *args, recurrent=None, tables=None):
        gates = xp if recurrent is None else xp.to(torch.float32) + recurrent
        return quant_lstm_cell_reference(gates, c, *args)

    saved = rnn.quant_lstm_cell, rnn.quant_lstm_cell_tables
    rnn.quant_lstm_cell, rnn.quant_lstm_cell_tables = plain, lambda *args: None
    try:
        yield
    finally:
        rnn.quant_lstm_cell, rnn.quant_lstm_cell_tables = saved


class PlainRun(torch.nn.Module):
    """Runs ``model`` inside ``context`` (a plain path's switch)."""

    def __init__(self, model, context):
        super().__init__()
        self.model = model
        self.context = context

    def forward(self, x):
        with self.context():
            return self.model(x)


def phase_lstm_qat(dev, bf16: bool = False) -> dict:
    """The leg's QAT step at full width: calibration, conversion to learned
    scales, a warm-up and LSTM_TIMED_STEPS timed Adam steps through the cell
    kernels, held against a copy that runs the module cell (float32) or,
    with ``bf16`` operands (``set_compute_dtype``, bench's default), the
    same fused step on the cell's plain version."""
    from brevitas_tpu_torch.quant.quantizers import convert_runtime_stats_to_parameter
    from brevitas_tpu_torch.utils import set_compute_dtype

    what = f"lstm_qat_{'bf16' if bf16 else 'float32'}"
    b, t, f = LSTM_LEG["batch"], LSTM_LEG["seq"], LSTM_LEG["feat"]
    launches_per_step = LSTM_LEG["layers"] * t
    gc.collect()  # the serving phases' models: keep their objects out of the step's time
    model = LSTMModel(dev, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    calib = torch.from_numpy(rng.random((b, t, f), dtype=np.float32)).to(dev)
    _reset_launch_counts()
    with torch.no_grad():
        model(calib)  # calibration: the quantizers collect, the module cell runs
    torch.cuda.synchronize()
    calib_counts = _launch_counts()
    print(f"[{what}] calibration forward: launches {calib_counts}")
    if calib_counts["quant_lstm_cell"] or calib_counts["quant_lstm_cell_backward"]:
        raise AssertionError("lstm_qat: the calibration forward launched a cell kernel")
    converted = convert_runtime_stats_to_parameter(model)
    if bf16:
        set_compute_dtype(model, torch.bfloat16)
    for layer in model.lstm.layers:
        if layer._kernel_cell_args(layer._fused_cell_params(), torch.float32) is None:
            raise AssertionError("lstm_qat: a layer does not take the cell kernel")
    routing = max(check_scale_routing(dev, layer) for layer in model.lstm.layers)
    print(f"[{what}] the backward kernel's scale sums reach each layer's 4 + 3 gate scales "
          f"and 4 scalar scales: max |grad - f64| / sum|term| {routing:.3g} (bound "
          f"{LSTM_SCALE_SUM_RTOL:g})")
    plain = copy.deepcopy(model)
    if bf16:
        plain = PlainRun(plain, plain_lstm_cell)
    else:
        for layer in plain.lstm.layers:
            layer.fused_cell = False
    start = {n: p.detach().clone() for n, p in model.named_parameters()}

    # the data as bench.py's _scanned_train draws it, for a warm-up and the timed steps
    n_steps = 1 + LSTM_TIMED_STEPS
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.random((n_steps, b, t, f), dtype=np.float32)).to(dev)
    ys = torch.from_numpy(rng.integers(0, 10, (n_steps, b))).to(dev)

    # gradients of the first step, the same parameters on both paths: the
    # forwards are the same bits, the backwards differ in rounding (the
    # kernel's analytic backward against autograd through the module cell).
    # A weight's gradient sums many terms of one sign pattern: within 1e-4 of
    # its largest element. A cell quantizer's learned scale reaches the
    # kernel path only through the backward kernel's sums, _grad_like and the
    # stack of the 4 + 3 gate scales: each within 1e-4 of the
    # largest cell-scale gradient, since its terms g * (q - x / s) cancel to a
    # remainder whose float32 error is set by the size of those terms, not by
    # its own (a swapped gate or a misrouted sum moves a scale's gradient by
    # its whole size). The layers' input quantizers are not in the cell.
    grads, first_losses = [], []
    for m in (model, plain):
        m.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(m(xs[0]), ys[0])
        loss.backward()
        first_losses.append(float(loss.detach()))
        grads.append({n.removeprefix("model."): p.grad.clone()
                      for n, p in m.named_parameters()})
        m.zero_grad(set_to_none=True)
    if first_losses[0] != first_losses[1]:
        raise AssertionError(f"lstm_qat: first-step losses differ {first_losses}")
    grad_dev = {n: float((g - grads[1][n]).abs().max()) / max(
        float(grads[1][n].abs().max()), 1e-30) for n, g in grads[0].items()}
    weight_dev = {n: v for n, v in grad_dev.items() if not n.endswith("scaling.value")}
    worst_weight = max(weight_dev, key=weight_dev.get)
    worst_scale = max((n for n in grad_dev if n not in weight_dev), key=grad_dev.get)
    print(f"[{what}] first-step loss the same bits on both paths ({first_losses[0]}); "
          f"gradients, kernel path vs module cell, max|diff| / max|grad|: weights at most "
          f"{weight_dev[worst_weight]:.3g} ({worst_weight}), learned scales at most "
          f"{grad_dev[worst_scale]:.3g} ({worst_scale})")
    cell_scales = [n for n in grad_dev if ".quants." in n and n.endswith("scaling.value")]
    cell_max = max(float(grads[1][n].abs().max()) for n in cell_scales)
    cell_dev = {n: float((grads[0][n] - grads[1][n]).abs().max()) / cell_max
                for n in cell_scales}
    worst_cell = max(cell_dev, key=cell_dev.get)
    report = {n.replace("lstm.layers.", "").replace(".scaling.value", ""): (
        float(f"{float(grads[1][n].abs().max()) / cell_max:.3g}"), float(f"{cell_dev[n]:.3g}"))
        for n in cell_scales}
    print(f"[{what}] cell-scale gradients ({len(cell_scales)} learned scales), kernel path "
          f"vs the plain cell, |diff| / {cell_max:.4g} (the largest): at most "
          f"{cell_dev[worst_cell]:.3g} ({worst_cell}); each as (|grad|, |diff|) / largest: "
          f"{report}")
    weight_rtol, cell_rtol = ((LSTM_BF16_GRAD_RTOL, LSTM_BF16_GRAD_RTOL) if bf16
                              else (1e-4, LSTM_CELL_SCALE_GRAD_RTOL))
    if weight_dev[worst_weight] > weight_rtol:
        raise AssertionError(f"{what}: gradient of {worst_weight} deviates")
    if cell_dev[worst_cell] > cell_rtol:
        raise AssertionError(f"{what}: gradient of {worst_cell} deviates")

    step = lstm_train_step(model)
    losses, times, total = [], [], None
    for i in range(n_steps):
        torch.cuda.synchronize()
        _reset_launch_counts()
        t0 = time.perf_counter()
        losses.append(step(xs[i], ys[i]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = _launch_counts()
        # the cell kernels once a time step and layer, the stage tables once
        # a layer; fake_quant for each layer's input quantizer and 4 + 4
        # gate-weight quantizers, forward and backward (each has a learned or
        # a weight-statistics scale)
        want = {k: LSTM_LEG["layers"] if k == "quant_lstm_cell_tables"
                else launches_per_step if k.startswith("quant_lstm_cell")
                else LSTM_FQ_PER_STEP if k.startswith("fake_quant") else 0 for k in counts}
        if counts != want:
            raise AssertionError(f"{what} step {i}: launches {counts}, expected {want}")
        total = counts if total is None else {k: total[k] + v for k, v in counts.items()}
    _record_path(what, total)
    plain_step = lstm_train_step(plain)
    plain_losses = [plain_step(xs[i], ys[i]) for i in range(n_steps)]
    torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    plain_losses = [float(x) for x in plain_losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"lstm_qat: losses {losses}")
    # after the first step the paths start from parameters that differ in
    # their last bits, so some of the millions of fake-quant codes a step
    # rounds flip at .5 ties, and the gradients of the batch rows concerned
    # change through the recurrence; Adam moves each coordinate by about lr
    # a step whatever its gradient's size, so single coordinates drift apart
    # by up to 2 lr a step. Held: each step's loss within 1e-3 relative, and
    # each weight's total update (w_ih, w_hh, bias, head) within 0.3 of its
    # size in norm (0.06-0.17 on an H100). A learned scale is one value whose
    # gradient cancels to a remainder, so Adam's step can turn with a flip:
    # its update deviations are reported only (the cell check bounds the
    # sums).
    loss_dev = max(abs(a - p) / abs(p) for a, p in zip(losses, plain_losses))
    update_dev, param_max = {}, 0.0
    plain_params = dict(plain.named_parameters())
    for n, p in model.named_parameters():
        q = plain_params.get(n, plain_params.get(f"model.{n}"))
        u_k, u_p = p.detach() - start[n], q.detach() - start[n]
        update_dev[n] = float((u_k - u_p).norm() / u_p.norm().clamp_min(1e-30))
        param_max = max(param_max, float((u_k - u_p).abs().max()))
    weights = {n: v for n, v in update_dev.items() if not n.endswith("scaling.value")}
    worst_update = max(weights, key=weights.get)
    print(f"[{what}] losses kernel path {losses}; plain cell {plain_losses}; largest "
          f"relative deviation {loss_dev:.3g}; after {n_steps} steps, |update difference| / "
          f"|update|: weights at most {weights[worst_update]:.3g} ({worst_update}), learned "
          f"scales at most {max(update_dev.values()):.3g}; largest |parameter diff| "
          f"{param_max:.3g}; all { {k: float(f'{v:.3g}') for k, v in update_dev.items()} }")
    if loss_dev > LSTM_LOSS_RTOL or weights[worst_update] > LSTM_UPDATE_RTOL:
        raise AssertionError("lstm_qat: the kernel path and the module cell drift apart")
    ms = statistics.median(times[1:])
    out = {"compute_dtype": "bf16" if bf16 else "float32",
           "ms_per_step": ms, "sequences_per_s": b / ms * 1e3, "step_ms": times,
           "launches_per_step": launches_per_step, "launches": total,
           "quantizers_converted": converted, "losses": losses, "plain_losses": plain_losses,
           "loss_rel_dev": loss_dev, "param_max_dev": param_max,
           "weight_update_rel_dev": weights[worst_update],
           "scale_update_rel_dev": max(update_dev.values()),
           "weight_grad_rel_dev": weight_dev[worst_weight],
           "scale_grad_rel_dev": grad_dev[worst_scale],
           "cell_scale_grad_dev": cell_dev[worst_cell], "scale_routing_dev": routing}
    print(f"[{what}] {ms:.3f} ms per training step (median of {LSTM_TIMED_STEPS}, host "
          f"clock with synchronize): {out['sequences_per_s']:.1f} sequences/s, "
          f"{out['compute_dtype']} operands, on {CARD[0]}")

    def one_step():
        step(xs[0], ys[0])
        torch.cuda.synchronize()

    out["profile"] = profile_steps(one_step, what, "training step", n=2, grad=True)
    print(f"[{what}] device idle share {out['profile']['idle_share']:.3f}, "
          f"{out['compute_dtype']} operands, on {CARD[0]}")
    # no gate add (and in bf16 no cast of xp) a time step: the cell kernel
    # forms xp + p. Torch's elementwise adds and dtype copies in one forward,
    # from the profile: the per-step add made layers x seq adds, and in bf16
    # each step also made 4 copies (h and W_hh rounded to bf16 and back in
    # the product, and xp's cast)
    with torch.no_grad():
        kernels = device_kernel_counts(lambda: model(xs[0]))
    adds = sum(n for k, n in kernels.items() if "CUDAFunctor_add" in k)
    copies = sum(n for k, n in kernels.items() if "copy_kernel" in k)
    per_step = LSTM_LEG["layers"] * t
    print(f"[{what}] one forward: {sum(kernels.values())} device kernels, {adds} elementwise "
          f"adds, {copies} dtype copies, over {per_step} cell steps")
    if adds >= per_step or (bf16 and copies >= 4 * per_step):
        raise AssertionError(f"{what}: a gate add or xp cast still runs a step: {adds} adds, "
                             f"{copies} copies a forward")
    out["forward_kernels"] = {"total": sum(kernels.values()), "adds": adds, "copies": copies}
    return out


def device_kernel_counts(fn) -> dict:
    """Launches of each device kernel (by name) in one call of ``fn``, from
    torch.profiler, after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("Activity Buffer")}


# fake_quant at the shapes of one lfc_qat step (lfc(4, 4, 4), batch 1024):
# (shape, forward launches, backward launches). The input x and the first
# layer's (out, in) weight are (1024, 784); two hidden weights and three
# activations (1024, 1024), forward and backward but the input's; the head's
# weight (10, 1024). The data's quantizer needs no gradient.
FQ_STEP_SHAPES = [((1024, 784), 2, 1), ((1024, 1024), 5, 5), ((10, 1024), 1, 1)]
FQ_EDGE_SHAPE = (3, 5, 7)
# (zero point, lo, hi, ste_clamp): LFC's narrow 4-bit grid, and zero point 3
FQ_CASES = [(0.0, -7.0, 7.0, False), (0.0, -7.0, 7.0, True), (3.0, -8.0, 7.0, False),
            (3.0, -8.0, 7.0, True)]
FQ_SUM_RTOL = 1e-5  # of sum |term|, against the float64 sum of the plain terms
FQ_BYTES = (8, 12)  # an element: forward reads x, writes y; backward reads x, g, writes dx


def profiled_device_ms(fn, n: int = 20) -> float:
    """Device time per call of ``fn`` from torch.profiler: the sum of its
    kernels' device time over ``n`` calls, for an op that waits for the card
    on the host inside each call (host gaps would enter CUDA-event times)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / n


def phase_fake_quant_kernels(dev, bw) -> list:
    """fake_quant's forward and backward kernels against their plain
    versions on the card at LFC's step shapes and an unaligned one, every
    case reaching both clamps: the forward and dx bit for bit, dscale and
    dzp within FQ_SUM_RTOL * sum |term| of the float64 sum of the plain
    terms, the same bits on a second run. Timed at the step shapes in the
    path's case (zero point 0, the zeroing clamp, no scale gradient).
    Returns one row per (kernel, shape)."""
    from brevitas_tpu_torch.kernels import (
        fake_quant,
        fake_quant_backward,
        fake_quant_backward_reference,
        fake_quant_reference,
    )
    from brevitas_tpu_torch.kernels.fake_quant import fake_quant_scale_terms

    g = torch.Generator(device=dev).manual_seed(5)
    # a 4-bit LFC grid's scale, divided on the card as rescaling_scale does
    scale = torch.ones((), device=dev) / torch.full((), 7.0, device=dev)
    rows, worst_sum = [], 0.0
    print("[fake_quant_kernels] kernel shape | kernel_ms plain_ms library_ms bound_ms "
          "bound_by (library: torch's fake-quant ops multiply by 1/s: the Pallas kernel's "
          "function, not the port's)")
    for shape in [sh for sh, _, _ in FQ_STEP_SHAPES] + [FQ_EDGE_SHAPE]:
        x = torch.randn(shape, generator=g, device=dev)
        gy = torch.randn(shape, generator=g, device=dev)
        for zp_v, lo, hi, ste in FQ_CASES:
            zp = torch.full((), zp_v, device=dev)
            codes = torch.round(x / scale + zp)
            if not (bool((codes < lo).any()) and bool((codes > hi).any())):
                raise AssertionError(f"fake_quant_kernels: a clamp is not reached at {shape}")
            with torch.no_grad():
                y_k = fake_quant(x, scale, zp, lo, hi, ste)
                y_r = fake_quant_reference(x, scale, zp, lo, hi, ste)
            got = fake_quant_backward(x, scale, zp, gy, lo, hi, ste)
            again = fake_quant_backward(x, scale, zp, gy, lo, hi, ste)
            want = fake_quant_backward_reference(x, scale, zp, gy, lo, hi, ste)
            ds_terms, dz_terms, _ = fake_quant_scale_terms(x, scale, zp, gy, lo, hi, ste)
            torch.cuda.synchronize()
            case = f"{shape} zp {zp_v} lo {lo} hi {hi} ste_clamp {ste}"
            if not torch.equal(y_k, y_r):
                raise AssertionError(f"fake_quant differs from its plain version at {case}: "
                                     f"{int((y_k != y_r).sum())} of {y_r.numel()}")
            if not torch.equal(got[0], want[0]):
                raise AssertionError(f"fake_quant_backward dx differs at {case}: "
                                     f"{int((got[0] != want[0]).sum())} of {x.numel()}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"fake_quant_backward: two runs differ at {case}")
            for name, k_, terms in (("dscale", got[1], ds_terms), ("dzp", got[2], dz_terms)):
                exact, mass = float(terms.sum()), float(terms.abs().sum())
                err = abs(float(k_) - exact)
                if err > FQ_SUM_RTOL * mass:
                    raise AssertionError(f"fake_quant_backward {name} at {case}: |kernel - f64| "
                                         f"{err:.3g} of sum |term| {mass:.3g}")
                worst_sum = max(worst_sum, err / mass if mass else 0.0)
        print(f"[fake_quant_kernels] {shape}: 4 cases, both clamps reached; forward and dx bit "
              f"for bit, dscale/dzp within {worst_sum:.3g} of sum |term|, same bits on a "
              "second run")
        if shape == FQ_EDGE_SHAPE:
            continue

        # times in the path's case
        n = x.numel()
        xr = x.detach().requires_grad_()
        s_host = float(scale)
        with torch.no_grad():
            t_fk = cuda_ms(lambda: fake_quant(x, scale, 0.0, -7.0, 7.0))
            t_fp = cuda_ms(lambda: fake_quant_reference(x, scale, 0.0, -7.0, 7.0))
            t_fl = cuda_ms(lambda: torch.fake_quantize_per_tensor_affine(x, s_host, 0, -7, 7))
        t_bk = cuda_ms(lambda: fake_quant_backward(x, scale, 0.0, gy, -7.0, 7.0, sums=False))
        t_bks = cuda_ms(lambda: fake_quant_backward(x, scale, 0.0, gy, -7.0, 7.0))
        y_plain = fake_quant_reference(xr, scale, 0.0, -7.0, 7.0)
        t_bp = cuda_ms(lambda: torch.autograd.grad(y_plain, xr, gy, retain_graph=True))
        # the learnable op's backward reads its scale on the host (.item())
        # at every call: its device time from the profiler
        s_l = scale.detach().reshape(1)
        z_l = torch.zeros(1, device=dev)
        t_bl = profiled_device_ms(
            lambda: torch.ops.aten._fake_quantize_learnable_per_tensor_affine_backward(
                gy, x, s_l, z_l, -7, 7, 1.0))
        for name, t_k, t_p, t_l, nbytes in (
                ("fake_quant", t_fk, t_fp, t_fl, FQ_BYTES[0] * n),
                ("fake_quant_backward", t_bk, t_bp, t_bl, FQ_BYTES[1] * n)):
            t_b = nbytes / bw * 1e3
            row = dict(kernel=name, shape=list(shape), ms=t_k, plain_ms=t_p, library_ms=t_l,
                       bound_ms=t_b, bound_by="bytes", err=0.0, scale_sum_ratio=worst_sum)
            if name == "fake_quant_backward":
                row["ms_with_sums"] = t_bks
            rows.append(row)
            print(f"[fake_quant_kernels] {name} {shape} | {t_k:.4f} {t_p:.4f} {t_l:.4f} "
                  f"{t_b:.3g} bytes" + (f" | with dscale/dzp sums {t_bks:.4f}"
                                        if name == "fake_quant_backward" else ""))
    return rows


def fake_quant_summary(rows, name, launches) -> dict:
    """A fake_quant kernel's times over one lfc_qat step: its launches at
    the step's shapes."""
    idx = 1 if name == "fake_quant" else 2
    per_shape = {tuple(r["shape"]): r for r in rows if r["kernel"] == name}
    sums = {key: sum(per_shape[sh][key] * sh_n[idx - 1] for sh, *sh_n in FQ_STEP_SHAPES)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    entry = {
        "name": name, "route": "cuda", "source": "brevitas_tpu_torch/csrc/fake_quant.cu",
        "replaces": "brevitas_tpu/kernels/fake_quant.py:110", "launches": launches,
        "max_abs_err": 0.0, **sums, "bound_by": "bytes",
        "per": f"one lfc_qat step at batch {LFC_QAT_BATCH}: "
               f"{sum(c[idx] for c in FQ_STEP_SHAPES)} launches",
        "library_note": "torch.fake_quantize_per_tensor_affine (forward) and the backward of "
                        "torch._fake_quantize_learnable_per_tensor_affine multiply by 1/s: they "
                        "compute the Pallas kernel's function, not the port's",
        "scale_sum_ratio": max(r["scale_sum_ratio"] for r in rows),
    }
    if name == "fake_quant_backward":
        entry["ms_with_sums"] = sum(per_shape[sh]["ms_with_sums"] * nb
                                    for sh, _, nb in FQ_STEP_SHAPES)
    return entry


@contextlib.contextmanager
def plain_fake_quant():
    """The quantizers' per-tensor fake-quant on the plain chain instead of
    the fake_quant kernels."""
    from brevitas_tpu_torch.kernels import fake_quant_reference
    from brevitas_tpu_torch.quant import quantizers

    saved = quantizers.fake_quant
    quantizers.fake_quant = fake_quant_reference
    try:
        yield
    finally:
        quantizers.fake_quant = saved


# bench.py's lfc_int4_qat leg (bench.py:388-400, _scanned_train :226-262):
# lfc(4, 4, 4, dropout=0.0), batch 1024, square hinge, Adam lr 1e-3,
# clip_weights(-1, 1); one scanned epoch is 30 steps
LFC_QAT_BATCH = 1024
LFC_QAT_STEPS = 30
LFC_QAT_LR = 1e-3
LFC_QAT_CPU_LOSS_RTOL = 1e-5  # the card's first loss against a CPU copy's
# fake_quant launches a step: 4 weight and 4 activation quantizers forward;
# the backward of all but the data's input quantizer
LFC_QAT_FQ = (8, 7)


def phase_lfc_qat(dev, bf16: bool) -> dict:
    """bench's lfc_int4_qat step at full width through the port's trainer
    step (examples.bnn_pynq.train_step), a warm-up and LFC_QAT_STEPS timed
    steps, in bf16 operands (bench's default) or float32. A copy on the card
    runs the plain chain in every quantizer: the warm-up step's loss and
    every gradient the same bits; each later step's loss difference
    reported. A CPU copy's first loss within LFC_QAT_CPU_LOSS_RTOL (BatchNorm
    and TensorNorm sum in another order on the CPU)."""
    from brevitas_tpu_torch.examples import bnn_pynq
    from brevitas_tpu_torch.models import lfc
    from brevitas_tpu_torch.utils import set_compute_dtype

    what = f"lfc_qat_{'bf16' if bf16 else 'float32'}"
    gc.collect()
    model = lfc(4, 4, 4, dropout=0.0, generator=torch.Generator().manual_seed(0), device=dev)
    if bf16:
        set_compute_dtype(model, torch.bfloat16)
    plain = copy.deepcopy(model)
    cpu_model = copy.deepcopy(model).to("cpu")
    # the data as bench.py's _scanned_train draws it
    rng = np.random.default_rng(0)
    xs_np = rng.random((LFC_QAT_STEPS, LFC_QAT_BATCH, 28, 28, 1), dtype=np.float32)
    ys_np = rng.integers(0, 10, (LFC_QAT_STEPS, LFC_QAT_BATCH)).astype(np.int32)
    xs, ys = torch.from_numpy(xs_np).to(dev), torch.from_numpy(ys_np).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=LFC_QAT_LR)
    plain_opt = torch.optim.Adam(plain.parameters(), lr=LFC_QAT_LR)

    # the warm-up step on both paths: the same loss and gradient bits
    _reset_launch_counts()
    loss0 = bnn_pynq.train_step(model, opt, xs[0], ys[0])
    torch.cuda.synchronize()
    warm_counts = _launch_counts()
    with plain_fake_quant():
        plain0 = bnn_pynq.train_step(plain, plain_opt, xs[0], ys[0])
    torch.cuda.synchronize()
    if not torch.equal(loss0, plain0):
        raise AssertionError(f"{what}: first-step loss {float(loss0)} differs from the plain "
                             f"chain's {float(plain0)}")
    plain_params = dict(plain.named_parameters())
    differ = [n for n, p in model.named_parameters()
              if not torch.equal(p.grad, plain_params[n].grad)]
    if differ:
        raise AssertionError(f"{what}: first-step gradients differ from the plain chain's: "
                             f"{differ}")
    with torch.no_grad():
        cpu_loss = float(bnn_pynq.sqr_hinge_loss(cpu_model(torch.from_numpy(xs_np[0])),
                                                 torch.from_numpy(ys_np[0])))
    cpu_dev = abs(float(loss0) - cpu_loss) / abs(cpu_loss)
    print(f"[{what}] warm-up step: loss {float(loss0)} the same bits as the plain chain's, "
          f"all {len(plain_params)} gradients the same bits; CPU copy's loss {cpu_loss} "
          f"(relative {cpu_dev:.3g}); launches {warm_counts}")
    if cpu_dev > LFC_QAT_CPU_LOSS_RTOL:
        raise AssertionError(f"{what}: the card's first loss is {cpu_dev:.3g} from a CPU copy's")
    fq_want = {"fake_quant": LFC_QAT_FQ[0], "fake_quant_backward": LFC_QAT_FQ[1]}
    if any(warm_counts[k] != v for k, v in fq_want.items()):
        raise AssertionError(f"{what}: fake_quant launches {warm_counts}, expected {fq_want}")

    # the timed steps: one scanned epoch of bench
    torch.cuda.synchronize()
    _reset_launch_counts()
    t0 = time.perf_counter()
    losses = [bnn_pynq.train_step(model, opt, xs[i], ys[i]) for i in range(LFC_QAT_STEPS)]
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    counts = _launch_counts()
    _record_path(what, {k: v + warm_counts[k] for k, v in counts.items()})
    want = {k: LFC_QAT_STEPS * fq_want.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts} over {LFC_QAT_STEPS} steps, "
                             f"expected {want}")
    with plain_fake_quant():
        plain_losses = [bnn_pynq.train_step(plain, plain_opt, xs[i], ys[i])
                        for i in range(LFC_QAT_STEPS)]
    losses = [float(v) for v in losses]
    plain_losses = [float(v) for v in plain_losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: losses {losses}")
    step_dev = [abs(a - b) for a, b in zip(losses, plain_losses)]
    param_dev = max(float((p.detach() - plain_params[n].detach()).abs().max())
                    for n, p in model.named_parameters())
    clip = max(float(lyr.weight.detach().abs().max()) for lyr in model.modules()
               if hasattr(lyr, "weight_quant"))
    if clip > 1.0:
        raise AssertionError(f"{what}: a weight outside [-1, 1] after clip_weights: {clip}")
    ms = total_ms / LFC_QAT_STEPS
    out = {"compute_dtype": "bf16" if bf16 else "float32", "ms_per_step": ms,
           "images_per_s": LFC_QAT_BATCH / ms * 1e3, "losses": losses,
           "first_loss": float(loss0), "cpu_first_loss_rel_dev": cpu_dev,
           "loss_dev_per_step": step_dev, "param_max_dev": param_dev,
           "fake_quant_per_step": counts["fake_quant"] / LFC_QAT_STEPS,
           "fake_quant_backward_per_step": counts["fake_quant_backward"] / LFC_QAT_STEPS}
    print(f"[{what}] {LFC_QAT_STEPS} steps: {ms:.3f} ms per step (host clock over the epoch, "
          f"synchronized at its end), {out['images_per_s']:.0f} images/s, "
          f"{out['compute_dtype']} operands, on {CARD[0]}; fake_quant launches per step "
          f"{out['fake_quant_per_step']:g} forward, {out['fake_quant_backward_per_step']:g} "
          f"backward; kernel path vs plain chain: loss |diff| per step max "
          f"{max(step_dev):.3g} ({step_dev}), parameters max |diff| {param_dev:.3g}")

    def one_step():
        bnn_pynq.train_step(model, opt, xs[0], ys[0])
        torch.cuda.synchronize()

    out["profile"] = profile_steps(one_step, what, "training step", n=3, grad=True)
    print(f"[{what}] device busy {out['profile']['busy_ms']:.4f} ms a step, idle share "
          f"{out['profile']['idle_share']:.3f}, {out['compute_dtype']} operands, on {CARD[0]}")
    return out


def phase_bnn_pynq(dev) -> dict:
    """The trainer's entry point on the card: examples.bnn_pynq.main, LFC
    4-bit, synthetic data, one epoch (20 steps at batch 100, then the
    evaluation of 512 images in 2 batches)."""
    from brevitas_tpu_torch.examples import bnn_pynq

    _reset_launch_counts()
    acc = bnn_pynq.main(["--network", "LFC_4W4A", "--dataset", "synthetic", "--epochs", "1",
                         "--device", str(dev)])
    torch.cuda.synchronize()
    counts = _launch_counts()
    _record_path("bnn_pynq", counts)
    steps, evals = 2048 // 100, 2
    want = {k: 0 for k in counts}
    want.update(fake_quant=LFC_QAT_FQ[0] * (steps + evals),
                fake_quant_backward=LFC_QAT_FQ[1] * steps)
    print(f"[bnn_pynq] main: val acc {acc} (synthetic labels: chance), launches {counts}")
    if counts != want:
        raise AssertionError(f"bnn_pynq: launches {counts}, expected {want}")
    if not 0.0 <= acc <= 1.0:
        raise AssertionError(f"bnn_pynq: accuracy {acc}")
    return {"val_acc": acc, "launches": counts}


def lstm_summary(rows, name, lstm, replaces, path):
    """An LSTM cell kernel's row at the leg's shape with the leg's scales
    (one per gate block) on the main path's ``path`` (the forward: two
    addends, a float32 xp, the stage tables); its launches over the QAT
    phases' warm-ups and timed steps (float32 and bf16 operands)."""
    row = next(r for r in rows if r["kernel"] == name and (r["b"], r["h"]) == (64, 512)
               and r["scales"] == "gate" and r["path"] == path)
    return {
        "name": name, "route": "cuda", "source": "brevitas_tpu_torch/csrc/quant_lstm_cell.cu",
        "replaces": replaces, "launches": sum(run["launches"][name] for run in lstm.values()),
        "max_abs_err": max(r["err"] for r in rows if r["kernel"] == name),
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None,
        "library_note": "no PyTorch call computes this function (six fake-quant stages "
                        "around the LSTM nonlinearities)",
        "per": f"one launch at B 64, H 512, sa and ss one per gate block (the leg's), {path}",
        "launches_per_step": lstm["float32"]["launches"][name] // (1 + LSTM_TIMED_STEPS),
        "by_shape_scales": [{k: r[k] for k in ("path", "b", "h", "scales", "ms", "plain_ms",
                                               "bound_ms", "bound_by", "err")}
                            for r in rows if r["kernel"] == name],
    }


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


def prefill_attention_entry(attn_rows, launches) -> dict:
    """int8_attention's row: the main path's shape, and every checked shape
    with its variant, times and code flips."""
    entry = attention_summary(attn_rows[0], "int8_attention", launches,
                              "brevitas_tpu_torch/csrc/int8_attention.cu",
                              "brevitas_tpu/kernels/int8_attention.py:98")
    entry["by_shape"] = [
        {k: r[k] for k in ("shape", "causal", "groups", "variant", "ms", "plain_ms",
                           "library_ms", "bound_ms", "bound_by", "flips", "codes", "err")}
        for r in attn_rows if r["kernel"] == "int8_attention"]
    return entry


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
    crossover = phase_int8_crossover(dev)
    rows += phase_int4_kernel(dev, peaks)
    int4_crossover = phase_int4_crossover(dev)
    attn_rows = phase_attention_kernels(dev, peaks)
    lstm_rows = phase_lstm_kernels(dev, VECTOR_PEAKS[sheet], peaks[0])
    fq_rows = phase_fake_quant_kernels(dev, peaks[0])
    serve_out, serve_int8 = phase_serve(dev)
    lfc_launches = phase_lfc(dev)
    prefill = phase_llama_prefill(dev)
    decode = {"int8kv": phase_llama_decode(dev, None), "int4kv": phase_llama_decode(dev, 4)}
    w4a8_prefill = phase_llama_prefill(dev, w4a8=True)
    w4a8_decode = phase_llama_decode(dev, None, w4a8=True)
    serve_decode = phase_serve_decode(dev)
    lstm = {"float32": phase_lstm_qat(dev), "bf16": phase_lstm_qat(dev, bf16=True)}
    lfc_qat = {"bf16": phase_lfc_qat(dev, bf16=True), "float32": phase_lfc_qat(dev, bf16=False)}
    trainer = phase_bnn_pynq(dev)

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
        "split_k_crossover": int4_crossover,
    }
    int8_entry = kernel_summary(rows, "int8_matmul", SERVE_BATCH, sum(int8_by_path.values()),
                                "brevitas_tpu_torch/csrc/int8_matmul.cu",
                                "brevitas_tpu/kernels/int_matmul.py:90",
                                "torch._int_mm needs N % 8 == 0; LFC's head has N = 10")
    int8_entry.update(launches_by_path=int8_by_path, split_k_crossover=crossover,
                      llama_prefill_forward=llama_gemm_sums(rows, PREFILL_BATCH * PREFILL_T),
                      llama_decode_step=llama_gemm_sums(rows, DECODE_BATCH))
    for r in attn_rows:
        r["flips_total"] = sum(x["flips"] for x in attn_rows if x["kernel"] == r["kernel"])
        r["max_err"] = max(x["err"] for x in attn_rows if x["kernel"] == r["kernel"])
    decode_entry = attention_summary(
        next(r for r in attn_rows if r.get("pos") == DECODE_STEPS - 1),
        "int4kv_decode_attention",
        decode["int4kv"]["launches"]["int4kv_decode_attention"]
        + serve_decode["serve_decode_kv4"]["launches"]["int4kv_decode_attention"],
        "brevitas_tpu_torch/csrc/int4kv_decode_attention.cu",
        "brevitas_tpu/kernels/int8_attention.py:324")
    decode_entry["by_shape_pos"] = [
        {k: r[k] for k in ("shape", "groups", "pos", "variant", "ms", "kernel_only_ms",
                           "plain_ms", "bound_ms", "flips")}
        for r in attn_rows if r["kernel"] == "int4kv_decode_attention"]
    decode_entry["split_crossover"] = next(r["split_crossover"] for r in attn_rows
                                           if "split_crossover" in r)
    decode_entry["ms_note"] = ("the counted call's device time, the wrapper's scale "
                               "arithmetic included; kernel_only_ms is the kernel alone, on "
                               "scales made once")
    decode_entry["kernel_only_ms"] = next(r["kernel_only_ms"] for r in attn_rows
                                          if r.get("pos") == DECODE_STEPS - 1)
    report = {"kernels": [
        int8_entry,
        int4_entry,
        kernel_summary(rows, "int4_weight_only_matmul", LFC_BATCH,
                       lfc_launches["int4_weight_only_matmul"],
                       "brevitas_tpu_torch/csrc/int4_weight_only_matmul.cu",
                       "brevitas_tpu/kernels/int4.py:229"),
        prefill_attention_entry(attn_rows, prefill["launches"]["int8_attention"]
                                + w4a8_prefill["launches"]["int8_attention"]),
        decode_entry,
        lstm_summary(lstm_rows, "quant_lstm_cell", lstm, "brevitas_tpu/kernels/lstm_cell.py:176",
                     "add_f32"),
        lstm_summary(lstm_rows, "quant_lstm_cell_tables", lstm,
                     "brevitas_tpu/kernels/lstm_cell.py:176 (the forward's sigmoid and tanh, "
                     "_cell_fwd_kernel:58)", "build"),
        lstm_summary(lstm_rows, "quant_lstm_cell_backward", lstm,
                     "brevitas_tpu/kernels/lstm_cell.py:224", "direct"),
        *(fake_quant_summary(fq_rows, name, sum(PATH_COUNTS[f"lfc_qat_{d}"][name]
                                                for d in lfc_qat))
          for name in ("fake_quant", "fake_quant_backward")),
    ], "serve": serve_out,
        "llama_prefill": {k: v for k, v in prefill.items() if k != "profile"},
        "llama_decode": {k: {kk: vv for kk, vv in v.items() if kk != "profile"}
                         for k, v in decode.items()},
        "llama_w4a8_prefill": {k: v for k, v in w4a8_prefill.items() if k != "profile"},
        "llama_w4a8_decode": {k: v for k, v in w4a8_decode.items() if k != "profile"},
        "serve_decode": {k: {kk: vv for kk, vv in v.items() if kk != "profile"}
                         for k, v in serve_decode.items()},
        "lstm_qat": {d: {k: v for k, v in run.items() if k != "profile"}
                     for d, run in lstm.items()},
        "lfc_qat": {d: {k: v for k, v in run.items() if k != "profile"}
                    for d, run in lfc_qat.items()},
        "bnn_pynq": trainer,
        "seconds": time.perf_counter() - t0}
    for entry in report["kernels"]:
        entry["launches_by_path"] = {path: counts[entry["name"]]
                                     for path, counts in PATH_COUNTS.items()}
        variants = {f"{r['m']}x{r['k']}x{r['n']}": r["variant"] for r in rows
                    if r["kernel"] == entry["name"] and "variant" in r}
        if variants:
            entry["variant_by_mkn"] = variants
    print(f"[done] {report['seconds']:.1f} s")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
