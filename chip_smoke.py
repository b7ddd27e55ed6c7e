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
             of a block and the head; torch._int_mm's yardstick at M 16 runs
             on rows padded to 32), int8_matmul at serve --decode's four
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
10b. llm_ptq - examples.llm_ptq.main at bench's Llama width (dim 1024,
             depth 6, 16 heads; batch 32, sequence 64, 4 calibration
             batches, 300 float training steps), run (a) --gptq
             --dynamic-act --convert-int (43 DynamicInt8InferenceLinear
             twins) and run (b) --convert-int --kv-bits 8 (SmoothQuant,
             static calibration, 6 Int8InferenceAttention twins): launches
             over main and over one served forward of a held-out batch
             asserted (43 int8_matmul a forward, and 6 int8_attention in
             (b)); each int8_matmul call of that forward bit for bit with
             int8_matmul_reference on the same codes; every twin of a CPU
             copy fed the card's input bit for bit, attention rows as
             below; the JAX tests' bounds on bits per character (a: quant
             and served below float + 0.1, served within 1e-3 of quant; b:
             quant below float + 1.5); each stage's host ms, the GPTQ row
             steps, ms a served forward and its device busy time. Runs
             (c) --arch gpt --rotate --awq --gpfq --convert-int (37
             Int8InferenceLinear twins, 56,320 GPFQ row steps) and (d)
             --arch gpt --mx --gptq --convert-int (MX weights: no GPTQ
             step, no twin, served bpc equal to quant bpc; every linear's
             MX weight codes and scales equal a CPU copy's) at the same
             width, checked the same way (quant and served below float +
             0.1).
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
             shapes of an lfc_qat step ((1024, 784), (1024, 1024), (10, 1024)),
             of a cnv_qat step (its nine activation quantizers' inputs, CNV's
             largest (256, 64, 30, 30) among them), of a mobilenet_qat step
             (MOBILENET_FQ_STEP_SHAPES: its 17 per-tensor quantizers' inputs,
             which the mobilenet_qat phase holds to its own calls) and an
             unaligned (3, 5, 7), zero points 0 and 3, both clamp modes, every
             clamp reached: forward and dx bit for bit against the plain
             versions on the card; dscale and dzp within 1e-5 * sum |term| of
             the float64 sum of the plain terms; the same bits on a second run.
             Then views of CNV's largest input flattened (FQ_VIEWS: x 4 and 8
             bytes off a 16-byte boundary, which take the scalar loop, 16
             bytes in, and lengths not a multiple of 4), forward and dx bit
             for bit, each printing the path it took. Times as above; the
             library point is torch's own fake-quant ops, which multiply by
             1/s (the Pallas kernel's function, not the port's).
11c. fake_quant_exhaustive - the forward kernel against fake_quant_reference
             on the card over every float32 bit pattern (2^32, in chunks of
             2^28 made on the card), at 18 scales (1/7 divided on the card,
             1, 2^-10, MobileNet's LOG_FP start, significands at their edges,
             FLT_MIN, 2e-16, 1e30 and 8 drawn from a seed in [1e-4, 1e2]) and
             5 grids (zero points 0 and 3 on (-7, 7) and (0, 255); zero point
             0 on (-2^30, 2^30), where the quotient's own bits reach y): the
             same bits everywhere, a NaN only as a NaN; prints the elements
             compared (386,547,056,640) and those that differ (raises on any).
11d. fake_quant_spread - fake_quant's forward over one lfc_qat, cnv_qat and
             mobilenet_qat step against torch.fake_quantize_per_tensor_affine,
             7 times each, alternating: each step's medians, their spreads
             and their ratio.
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
12c. cnv_qat - bench.py's cnv_int4pc_qat and cnv_int8pc_qat legs at full
             width, nothing cut: cnv(bits, bits, 8, per_channel_weights=True),
             batch 256, data drawn as _scanned_train draws it (transposed to
             NCHW), the square hinge loss, Adam lr 1e-3 and clip_weights(-1,
             1) through train_step; a warm-up and 10 timed steps, in bf16
             operands and in float32. 9 fake_quant and 8 fake_quant_backward
             launches a step (the per-channel weights take the plain chain).
             A copy on the card runs the plain chain: the warm-up's loss and
             every gradient the same bits; a CPU copy's first loss within 1e-5,
             its codes set to the card's at certified .5 ties.
             First the port's conv (a patch matrix, one strided copy of the
             input, times the weight matrix in float32): a float32
             QuantConv2d with TF32 allowed process-wide within K 2^-24 of
             float64, output and both gradients; and at CNV's six conv
             shapes, exact on integer codes both ways (cuDNN's F.conv2d, whose
             Winograd and FFT algorithms are not, counted and timed beside).
12d. bnn_pynq - examples.bnn_pynq.main(["--network", "LFC_4W4A" and then
             "CNV_4W4A", "--dataset", "synthetic", "--epochs", "1"]) on the
             card, its launches counted (CNV_4W4A's const-scale weights
             launch fake_quant too: 18 and 17 a step), its checkpoint in a
             temporary directory.
12h. bnn_pynq_binary - the same main at the reference's default (no
             --network: LFC_1W1A) and with --cfg lfc_1w2a, cnv_1w1a and
             cnv_2w2a: fake_quant launches a step 0 + 0, 4 + 3, 1 + 0 and
             18 + 17 (binary quantizers run their plain sign ops, as the JAX
             package does: it has no kernel for them).
12i. binary_qat - lfc_qat's step at lfc(1, 2, 2), batch 1024, and cnv_qat's
             at cnv(2, 2, 8) with the trainer's const-scale weights, batch
             256, each in bf16 operands and float32, checked as 12b and 12c:
             4 + 3 and 18 + 17 fake_quant launches a step.
12j. quant_options - each quantizer option of slice 8 at (1024, 1024) on
             the card against the same module copied to the CPU, one call
             with a gradient: ROUND_TO_ZERO, DPU_ROUND, the INT restriction,
             STATS zero points per tensor and per channel, a learned zero
             point (quantized and not), learned bit widths and stochastic
             rounding (both sides fed the same noise): values, scales, zero
             points and bit widths bit for bit, gradients within 6e-4 of sum
             |g| (1 + max |x|), fake_quant launched only where
             int_fake_quant's rule sends it (per tensor, round half to even,
             a constant bit width); the learned zero point's dzp from the
             backward kernel within 1e-5 of sum |term| of the float64 sum
             of its terms, the plain chain's autograd sum within 6e-4; and
             ShiftedUint8ActPerTensorFloat's two-phase zero point over 3
             collection calls, the handoff and one after, then eval, its
             state bit for bit with the CPU copy at every call.
12e. exact_route - Int8InferenceConv's exact integer route at QuartzNet's
             depthwise shapes (k 33 at stride 2 and 1, k 75, k 87 at dilation
             2; float32: the worst-case sum stays below 2^24) and at CNV's
             256-channel 3 x 3 (float64), on full-range int8 codes: every sum
             equal to a float64 conv on the CPU; timed.
12f. quartznet_serving - bench.py's quartznet_int8_serving leg at full width:
             quartznet_15x5() (random weights, seed 0) calibrated by one
             train-mode forward on bench's features (4 x 256 x 64, in the
             port's (B, C, T)), converted (171 Int8InferenceConv twins: 94
             pointwise on int8_matmul, 77 depthwise on the exact route),
             served 8 batches: 94 int8_matmul and 185 fake_quant launches a
             forward. A CPU copy: each twin fed the card's input bit for bit
             (the first depthwise conv, on raw features, within (K + 2)
             2^-24 of sum |x w|), BatchNorms within 1e-6, logits within 1e-5
             with codes set to the card's at certified ties. ms a batch,
             sequences/s, device busy time and idle share.
12g. mobilenet_qat - bench.py's mobilenetv1_4b_qat leg at full width, nothing
             cut: quant_mobilenet_v1(bit_width=4), batch 32 at 224 px drawn as
             _scanned_train draws them, softmax cross-entropy, Adam lr 1e-3,
             no clipping; a warm-up and 3 timed steps in bf16 operands and in
             float32. 17 fake_quant and 17 fake_quant_backward launches a
             step. A copy on the card on the plain chain: the warm-up's loss
             the same bits, and every gradient but those the kernel's scale
             sums reach (the 15 per-tensor learned thresholds and the head's
             weight: within 1e-3 of their largest); a CPU copy's first loss
             within 1e-5, its codes set to the card's at certified ties.
12h. ptq_calibrate - examples.ptq_calibrate.main on the repository's digits,
             at the CLI's defaults: (a) --model mlp --per-channel
             --learned-round --convert-int (1,000 AdaRound steps a layer),
             (b) --model convnet --fixed-point --gptq --convert-int. Every
             fake_quant and int8_matmul call over main held against its
             plain version as it returns (each 32-bit bias call also against
             the chain); the twins (3 Int8InferenceLinear; 1 and 2
             Int8InferenceConv) and 2 int8_matmul launches a linear over
             main; the converted model's twins and logits bit for bit with
             a CPU copy; the JAX tests' accuracy bounds; host ms a stage and
             AdaRound's per-layer output MSE.
12i. flexml_resnet18 - float_resnet(18, width_mult=1.0) on bench's CNV
             inputs: BatchNorm statistics from 10 train-mode forwards at
             batch 256, preprocess_flexml from one image (20 pairs, the 12
             regions the CPU tests hold to JAX), quantize_flexml,
             calibration (4 batches), bias correction (2), the fake-quant
             forward (63 fake_quant launches, within the JAX zoo test's
             bound of float), convert_integer_inference and a served
             forward at batch 256 (4 int8_matmul launches: the head and the
             3 strided shortcuts; 17 convs on the exact route), every call
             against its plain version, the twins and 16 rows of logits
             bit for bit with a CPU copy; served against fake-quant, host
             ms a stage, a profile of the served forward.
12j. export - the exporters (slice 10) on the card, every fake_quant call
             held against its plain version: (a) ptq_calibrate.main at the
             CLI's defaults with --model mlp --export qcdq, --model mlp
             --export qop and --model convnet --fixed-point --export
             qonnx: the file validates, the interpreter (each activation
             quantizer held to the card's codes, a flip only at a certified
             .5 tie) gives the card's output on the 360 test digits within
             the JAX export tests' tolerance (linear 1e-4, conv rtol 1e-3 and
             atol 1e-4, QOp one accumulator step) and, run free, scores
             ptq_acc; (b) LFC INT4 at 784-1024-1024-1024-10 after 3 QAT
             steps: QONNX, FINN and QCDQ on 64 rows, export_native and
             load_native (its integer weights the model's codes),
             export_torch_qcdq traced on the card within 1e-5 of the model;
             (c) CNV_4W4A: QCDQ and FINN on 8 images; (d) the flexml
             ResNet-18: QCDQ through the derived residual walk (20 convs)
             on 2 images. Each export's ms, bytes and flips (FINN's
             half-up ties among them).
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
import os
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
SLEEP_MS = 10.0


def cuda_ms(fn, reps: int = 25, inner: int = 10, device_only: bool = True) -> float:
    """Median over ``reps`` windows of ``inner`` back-to-back calls, in ms
    per call, timed with CUDA events after a warm-up (inputs stay hot in L2,
    as a served model's weights do).

    ``device_only``: the card first sleeps while the host enqueues the
    window, so the events time the device work alone, not the host's launch
    overhead; the sleep grows in steps of SLEEP_CYCLES to twice the time the
    warm-up took to enqueue a window. Without it the time per call includes
    that overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    sleep = 1
    if device_only:
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        sleep = max(1, -(-2 * (time.perf_counter() - t0) * 1e3 // SLEEP_MS))
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(int(sleep) * SLEEP_CYCLES)
        t0 = time.perf_counter()
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
        if device_only and enqueue_ms > 0.8 * sleep * SLEEP_MS:
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
            + [(SERVE_DECODE["batch"], k, n) for k, n in SERVE_DECODE_KN]
            + [(QN_M, k, n) for k, n in QUARTZNET_KN_COUNT])
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
            if k % 8 == 0:
                # torch._int_mm needs N % 8 == 0 and M > 16: a head of another
                # N (LFC's 10, QuartzNet's decoder's 29) is timed on weights
                # stored padded with zero columns, and an M of 16 or less (a
                # decode step's) on activations padded with zero rows to 32,
                # the padding's output dropped
                w_l = torch.nn.functional.pad(w, (0, -n % 8))
                x_l = torch.nn.functional.pad(x, (0, 0, 0, 32 - m)) if m <= 16 else x
                t_l = cuda_ms(lambda: torch._int_mm(x_l, w_l)[:m, :n].to(torch.float32)
                              * (xs * ws) + b)
                lib = f"{t_l:.4f}" + (f"(N padded to {w_l.shape[1]})" if n % 8 else "") + (
                    f"(M padded to {x_l.shape[0]})" if m <= 16 else "")
            else:
                t_l, lib = None, "n/a(_int_mm needs K%8=0)"
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
          + ", ".join(f"{k[:100]} {t:.4f}" for k, t in top))
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


# examples.llm_ptq at the width of bench.py's Llama legs (bench.py:577): dim
# 1024, depth 6, 16 heads (Llama's SwiGLU width 2,752, gpt's MLP 4,096), at
# the CLI's batch (32), sequence (64), calibration batches (4), bit width (8)
# and float training steps (300); each run names its arch
LLM_PTQ_ARGV = ["--dim", "1024", "--depth", "6", "--heads", "16"]
LLM_PTQ_RUNS = {"dynamic_gptq": ["--arch", "llama", "--gptq", "--dynamic-act", "--convert-int"],
                "static_kv8": ["--arch", "llama", "--convert-int", "--kv-bits", "8"],
                "gpt_rotate_awq_gpfq": ["--arch", "gpt", "--rotate", "--awq", "--gpfq",
                                        "--convert-int"],
                "gpt_mx": ["--arch", "gpt", "--mx", "--gptq", "--convert-int"]}
LLM_PTQ_TEST_BATCHES = 2   # main scores bits per character on 2 held-out batches
LLM_PTQ_CALIB_BATCHES = 4
# the linears: Llama's 7 a block (q, k, v, o, gate, up, down), gpt's 6 (q,
# k, v, out, fc1, fc2), and the head
LLM_PTQ_LINEARS = {"dynamic_gptq": 6 * 7 + 1, "static_kv8": 6 * 7 + 1,
                   "gpt_rotate_awq_gpfq": 6 * 6 + 1, "gpt_mx": 6 * 6 + 1}
_GPT = LLM_PTQ_LINEARS["gpt_rotate_awq_gpfq"]
# fake_quant launches over main, one a per-tensor quantizer call: the traced
# forward of the region search (in training mode, its quantizers
# collecting); the fake-quant scoring forwards (2 batches); the conversion's
# probe of each quantizer it freezes (a (1, 1) call); and GPFQ's capture
# forwards, each layer's 4 calibration batches through every input
# quantizer, and that layer's own once more on what it captured. (a) has
# the linears' 43 input quantizers, then dynamic ones; (b) adds q/k/v/probs,
# 11 a block, 67 in all; (c) the 37 linears' static inputs, and the
# conversion probes each block's 4 projections twice (the attention twin
# builds their twins, then refuses its unquantized core); (d)'s MX linears
# refuse their twin before its probe, so the served scoring forwards are
# fake-quant too
LLM_PTQ_FQ = {"dynamic_gptq": 6 * 7 + 1, "static_kv8": (6 * 11 + 1) * 4,
              "gpt_rotate_awq_gpfq": _GPT + _GPT * LLM_PTQ_CALIB_BATCHES * (_GPT + 1)
              + LLM_PTQ_TEST_BATCHES * _GPT + _GPT + 6 * 4,
              "gpt_mx": _GPT + 2 * LLM_PTQ_TEST_BATCHES * _GPT}
# the serving twins each run leaves, and the weight solver's row steps:
# GPTQ at Llama's width 6 x (4 x 1,024 + 2 x 1,024 + 2,752) + 1,024;
# GPFQ at gpt's 6 x (5 x 1,024 + 4,096) + 1,024; GPTQ skips MX weights
LLM_PTQ_TWINS = {"dynamic_gptq": {"DynamicInt8InferenceLinear": 6 * 7 + 1},
                 "static_kv8": {"Int8InferenceLinear": 6 * 7 + 1, "Int8InferenceAttention": 6},
                 "gpt_rotate_awq_gpfq": {"Int8InferenceLinear": _GPT},
                 "gpt_mx": {}}
LLM_PTQ_STEPS = {"dynamic_gptq": ("gptq_steps", 6 * (6 * 1024 + 2752) + 1024),
                 "static_kv8": ("gptq_steps", 0),
                 "gpt_rotate_awq_gpfq": ("gpfq_steps", 6 * (5 * 1024 + 4096) + 1024),
                 "gpt_mx": ("gptq_steps", 0)}
LLM_PTQ_CHECK_SEQS = 4     # sequences of a served batch held against a CPU copy
# bpc over float, the JAX tests'. At this width the model memorizes the
# corpus (float bpc about 0.046), so these bounds are loose; the two below,
# from the bpc measured on an H100 (quant 1.5e-5 to 2.2e-5 over float,
# served within 4.8e-6 of quant in (a) and (b)), are the ones that can
# fail. (c) and (d) were given the same bounds before their first run on
# the card: 8-bit weights after rotation, AWQ and GPFQ, or MX groups of 32,
# should cost the memorized corpus no more than (a)'s GPTQ did; (c)'s static
# twins are (b)'s, and (d) serves its fake-quant model itself (0)
LLM_PTQ_BOUNDS = {"dynamic_gptq": 0.1, "static_kv8": 1.5, "gpt_rotate_awq_gpfq": 0.1,
                  "gpt_mx": 0.1}
LLM_PTQ_QUANT_OVER_FLOAT = 1e-3  # every run
# |served - quant|: run (a)'s dynamic twin is numerically the fake-quant
# model (the JAX twin's docstring); the static twins as measured
LLM_PTQ_SERVED_VS_QUANT = {"dynamic_gptq": 1e-3, "static_kv8": 1e-4,
                           "gpt_rotate_awq_gpfq": 1e-4, "gpt_mx": 0.0}


@contextlib.contextmanager
def recorded_int8_matmul_calls(store: list):
    """``graph.convert_int.int8_matmul`` recording each call's arguments and
    result (the launch still counted)."""
    from brevitas_tpu_torch.graph import convert_int as CI

    real = CI.int8_matmul

    def recording(*args, **kw):
        y = real(*args, **kw)
        store.append((args, kw, y))
        return y

    CI.int8_matmul = recording
    try:
        yield
    finally:
        CI.int8_matmul = real


def check_llm_twins(model, ids: torch.Tensor, what: str) -> int:
    """Serve ``ids`` and hold a CPU copy of the served model against the
    card, layer by layer: every int8_matmul twin of the copy (dynamic or
    static) fed the card's input to it, bit for bit; the attention twins
    through AttentionTap (at most 1 % of token rows differ, S3) and then the
    copy's logits fed the card's attention outputs, bit for bit; and the
    free-running copy's logits (compare_logits: a float attention core sums
    in another order on the CPU). The first LLM_PTQ_CHECK_SEQS sequences.
    A QuantLinear no twin took (an MX one) serves its fake-quant forward:
    its weight codes and scales equal the CPU copy's bit for bit. Returns
    the twins checked."""
    from brevitas_tpu_torch.graph.convert_int import (
        DynamicInt8InferenceLinear,
        Int8InferenceLinear,
    )
    from brevitas_tpu_torch.nn import QuantLinear

    n = LLM_PTQ_CHECK_SEQS
    cpu_model = copy.deepcopy(model).to("cpu")
    fake = [name for name, mod in model.named_modules() if isinstance(mod, QuantLinear)]
    with torch.no_grad():
        for name in fake:
            got = model.get_submodule(name).quant_weight()
            want = cpu_model.get_submodule(name).quant_weight()
            if not (torch.equal(got.int().cpu(), want.int())
                    and torch.equal(got.scale.cpu(), want.scale)):
                raise AssertionError(f"{what}: {name}'s weight codes or scales differ from "
                                     "the CPU copy's")
    if fake:
        print(f"[{what}] {len(fake)} fake-quant linears: weight codes and scales of the CPU "
              "copy equal the card's bit for bit")
    seen = []
    hooks = [mod.register_forward_hook(
        lambda mod, args, out, name=name: seen.append(
            (name, _to_cpu(args[0][:n]), out[:n].cpu())))
        for name, mod in model.named_modules()
        if isinstance(mod, (DynamicInt8InferenceLinear, Int8InferenceLinear))]
    tap = AttentionTap(model, n)
    try:
        with torch.no_grad():
            logits = model(ids)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
        tap.detach()
    kinds, worst = {}, 0.0
    with torch.no_grad():
        for name, inp, got in seen:
            twin = cpu_model.get_submodule(name)
            want = twin(inp)
            kinds[type(twin).__name__] = kinds.get(type(twin).__name__, 0) + 1
            worst = max(worst, float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"{what}: twin {name} disagrees with its CPU copy")
        print(f"[{what}] {len(seen)} int8_matmul twins {kinds} of the CPU copy fed the card's "
              f"inputs ({n} sequences): bit for bit (max |diff| {worst:.3g})")
        cpu_ids = ids[:n].cpu()
        compare_logits(logits[:n].cpu(), cpu_model(cpu_ids), what)
        if tap.mods:
            replay = AttentionTap(cpu_model, n, replay=tap.record)
            check_replay(replay, cpu_model(cpu_ids), logits[:n].cpu(), what)
    return len(seen)


def phase_llm_ptq(dev, run: str) -> dict:
    """examples.llm_ptq.main on the card at full width (LLM_PTQ_ARGV), run
    (a) ``--arch llama --gptq --dynamic-act --convert-int`` (every linear a
    DynamicInt8InferenceLinear), (b) ``--arch llama --convert-int --kv-bits
    8`` (SmoothQuant, static calibration, the attention core on
    int8_attention), (c) ``--arch gpt --rotate --awq --gpfq --convert-int``
    (every linear an Int8InferenceLinear) or (d) ``--arch gpt --mx --gptq
    --convert-int`` (MX weights: GPTQ skips them, no twin takes them): the
    twins (LLM_PTQ_TWINS), the solver's row steps (LLM_PTQ_STEPS) and the
    launches over main (its two served scoring forwards, and fake_quant as
    LLM_PTQ_FQ says) and over one served forward of a held-out batch,
    asserted; each int8_matmul call of that forward against
    int8_matmul_reference on the same codes, bit for bit; the twins against
    a CPU copy (check_llm_twins); the JAX tests' bpc bounds and the
    measured ones (LLM_PTQ_QUANT_OVER_FLOAT, LLM_PTQ_SERVED_VS_QUANT); each
    stage's host ms, ms a served forward and its device busy time."""
    from brevitas_tpu_torch.examples import llm_ptq
    from brevitas_tpu_torch.graph.convert_int import (
        DynamicInt8InferenceLinear,
        Int8InferenceAttention,
        Int8InferenceLinear,
    )
    from brevitas_tpu_torch.kernels import int8_matmul_reference

    what = f"llm_ptq_{run}"
    linears = LLM_PTQ_LINEARS[run]
    want_twins = dict.fromkeys(("DynamicInt8InferenceLinear", "Int8InferenceLinear",
                                "Int8InferenceAttention"), 0)
    want_twins.update(LLM_PTQ_TWINS[run])
    served_linears = want_twins["DynamicInt8InferenceLinear"] + want_twins["Int8InferenceLinear"]
    attn = want_twins["Int8InferenceAttention"]
    keep = {}
    _reset_launch_counts()
    t0 = time.perf_counter()
    result = llm_ptq.main(LLM_PTQ_ARGV + LLM_PTQ_RUNS[run] + ["--device", str(dev)], keep=keep)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = _launch_counts()
    _record_path(what, counts)
    expected = dict.fromkeys(counts, 0)
    expected.update(int8_matmul=served_linears * LLM_PTQ_TEST_BATCHES,
                    int8_attention=attn * LLM_PTQ_TEST_BATCHES,
                    fake_quant=LLM_PTQ_FQ[run])
    print(f"[{what}] main {main_s:.1f} s ({CARD[0]}): launches {counts}")
    if counts != expected:
        raise AssertionError(f"{what}: expected launches {expected} over main")
    steps_key, want_steps = LLM_PTQ_STEPS[run]
    if result[steps_key] != want_steps:
        raise AssertionError(f"{what}: {result[steps_key]} {steps_key}, expected {want_steps}")

    model, test_x = keep["model"], keep["test_x"]
    twins = {cls.__name__: sum(isinstance(m, cls) for m in model.modules())
             for cls in (DynamicInt8InferenceLinear, Int8InferenceLinear, Int8InferenceAttention)}
    if twins != want_twins:
        raise AssertionError(f"{what}: serving twins {twins}, expected {want_twins}")

    ids = test_x[0]
    calls = []
    _reset_launch_counts()
    with torch.no_grad(), recorded_int8_matmul_calls(calls):
        model(ids)
    torch.cuda.synchronize()
    per_forward = _launch_counts()
    want_fwd = dict.fromkeys(per_forward, 0)
    # a linear no twin took serves its fake-quant forward: its input quantizer
    want_fwd.update(int8_matmul=served_linears, int8_attention=attn,
                    fake_quant=0 if served_linears else linears)
    print(f"[{what}] one served forward of {tuple(ids.shape)}: launches {per_forward}")
    if per_forward != want_fwd:
        raise AssertionError(f"{what}: expected launches {want_fwd} a served forward")
    shapes = set()
    with torch.no_grad():
        for args, kw, y in calls:
            if not torch.equal(y, int8_matmul_reference(*args, **kw)):
                raise AssertionError(f"{what}: int8_matmul at {tuple(args[0].shape)} x "
                                     f"{tuple(args[1].shape)} differs from its plain version")
            shapes.add((args[0].shape[0], *args[1].shape))
    print(f"[{what}] {len(calls)} int8_matmul calls against int8_matmul_reference on the same "
          f"codes: bit for bit; (M, K, N) {sorted(shapes)}")
    checked = check_llm_twins(model, ids, what)

    fb, qb, sb = result["float_bpc"], result["quant_bpc"], result["served_bpc"]
    bound = LLM_PTQ_BOUNDS[run]
    print(f"[{what}] bits per character: float {fb}, quant {qb}, served {sb} (bounds: quant "
          f"and served below float + {bound}, quant within {LLM_PTQ_QUANT_OVER_FLOAT} of float, "
          f"served within {LLM_PTQ_SERVED_VS_QUANT[run]} of quant)")
    if not all(np.isfinite(v) for v in (fb, qb, sb)):
        raise AssertionError(f"{what}: bits per character not finite")
    # the JAX tests bound the served bpc of every run but (b), whose test
    # (tests/test_llama.py's CLI smoke) bounds only the fake-quant one
    if qb >= fb + bound or (run != "static_kv8" and sb >= fb + bound):
        raise AssertionError(f"{what}: bits per character out of the JAX tests' bound")
    if abs(qb - fb) > LLM_PTQ_QUANT_OVER_FLOAT:
        raise AssertionError(f"{what}: fake-quant {qb} and float {fb} bpc differ")
    if abs(sb - qb) > LLM_PTQ_SERVED_VS_QUANT[run]:
        raise AssertionError(f"{what}: served {sb} and fake-quant {qb} bpc differ")

    def forward():
        model(ids)
        torch.cuda.synchronize()

    with torch.no_grad():
        forward()
        times = []
        for _ in range(5):
            t1 = time.perf_counter()
            forward()
            times.append((time.perf_counter() - t1) * 1e3)
    ms = statistics.median(times)
    print(f"[{what}] stages (host ms, {CARD[0]}): {result['stage_ms']}; GPTQ row steps "
          f"{result['gptq_steps']}, GPFQ row steps {result['gpfq_steps']}; {ms:.3f} ms a served "
          f"forward of {tuple(ids.shape)} (median of 5, host clock with synchronize)")
    out = {"card": CARD[0], "bpc": {"float": fb, "quant": qb, "served": sb},
           "launches_over_main": counts, "launches_per_forward": per_forward,
           "stage_ms": result["stage_ms"], "gptq_steps": result["gptq_steps"],
           "gpfq_steps": result["gpfq_steps"], "regions": result["regions"],
           "main_s": main_s, "ms_per_forward": ms, "twins_checked": checked}
    out["profile"] = profile_steps(forward, what, "served forward")
    return out


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
# fake_quant at the shapes of one cnv_qat step (cnv(bits, bits, 8), batch
# 256), the same way: the data's input quantizer (forward only), the six conv
# outputs' quantizers, the first at CNV's largest activation, and the two
# hidden FC ones; the per-channel weight quantizers take the plain chain
CNV_FQ_STEP_SHAPES = [((256, 3, 32, 32), 1, 0), ((256, 64, 30, 30), 1, 1),
                      ((256, 64, 28, 28), 1, 1), ((256, 128, 12, 12), 1, 1),
                      ((256, 128, 10, 10), 1, 1), ((256, 256, 3, 3), 1, 1),
                      ((256, 256, 1, 1), 1, 1), ((256, 512), 2, 2)]
# fake_quant at the shapes of one mobilenet_qat step (quant_mobilenet_v1(4),
# batch 32 at 224 px), the same way: the 13 depthwise ReLUs' inputs (the
# stem's 3 x 3 VALID conv at stride 2 takes 224 px to 111, each later
# stage's first depthwise conv halves it: 56, 28, 14, 7), the last stage's
# two pointwise ReLUs, the head's (1000, 1024) weight and its IntBias; the
# per-channel weights and ReLUs take the plain chain. phase_mobilenet_qat
# holds these to its warm-up step's calls.
MOBILENET_FQ_STEP_SHAPES = [((32, 32, 111, 111), 1, 1), ((32, 64, 56, 56), 1, 1),
                            ((32, 128, 56, 56), 1, 1), ((32, 128, 28, 28), 1, 1),
                            ((32, 256, 28, 28), 1, 1), ((32, 256, 14, 14), 1, 1),
                            ((32, 512, 14, 14), 5, 5), ((32, 512, 7, 7), 1, 1),
                            ((32, 1024, 7, 7), 3, 3), ((1000, 1024), 1, 1), ((1000,), 1, 1)]
FQ_STEPS = {"lfc_qat": FQ_STEP_SHAPES, "cnv_qat": CNV_FQ_STEP_SHAPES,
            "mobilenet_qat": MOBILENET_FQ_STEP_SHAPES}
FQ_EDGE_SHAPE = (3, 5, 7)
# views of CNV's largest step input, flattened: x starting 4, 8 and 16 bytes
# past the allocation (the first two off a 16-byte boundary: the scalar
# loop), and lengths that are not a multiple of 4 (a scalar tail)
FQ_VIEWS = [("offset 1", 1, None), ("offset 2, ragged", 2, -3), ("offset 4", 4, None),
            ("ragged length", 0, -1)]
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
    versions on the card at LFC's, CNV's and MobileNet's step shapes and an
    unaligned one, every case reaching both clamps: the forward and dx bit
    for bit, dscale and dzp within FQ_SUM_RTOL * sum |term| of the float64
    sum of the plain terms, the same bits on a second run; then the forward
    and dx at the views of FQ_VIEWS. Timed at the step shapes in the path's
    case (zero point 0, the zeroing clamp, no scale gradient), and the
    forward at the first view (the scalar loop). Returns one row per
    (kernel, shape)."""
    from brevitas_tpu_torch.kernels import (
        fake_quant,
        fake_quant_backward,
        fake_quant_backward_reference,
        fake_quant_reference,
    )
    from brevitas_tpu_torch.kernels.fake_quant import fake_quant_plan, fake_quant_scale_terms

    g = torch.Generator(device=dev).manual_seed(5)
    # a 4-bit LFC grid's scale, divided on the card as rescaling_scale does
    scale = torch.ones((), device=dev) / torch.full((), 7.0, device=dev)
    rows, worst_sum = [], 0.0
    print("[fake_quant_kernels] kernel shape | kernel_ms plain_ms library_ms bound_ms "
          "bound_by (library: torch's fake-quant ops multiply by 1/s: the Pallas kernel's "
          "function, not the port's)")
    shapes = [sh for step in FQ_STEPS.values() for sh, _, _ in step] + [FQ_EDGE_SHAPE]
    for shape in shapes:
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

    # views: the float4 body where x starts on a 16-byte boundary, the
    # scalar loop where it does not, scalar tails
    flat = torch.randn(CNV_FQ_STEP_SHAPES[1][0], generator=g, device=dev).flatten()
    g_flat = torch.randn(flat.shape, generator=g, device=dev)
    for what, start, stop in FQ_VIEWS:
        x, gy = flat[start:stop], g_flat[start:stop]
        vecs = fake_quant_plan(x.data_ptr(), torch.empty_like(x).data_ptr(), x.numel())
        for zp_v, lo, hi, ste in FQ_CASES:
            zp = torch.full((), zp_v, device=dev)
            with torch.no_grad():
                y_k = fake_quant(x, scale, zp, lo, hi, ste)
                y_r = fake_quant_reference(x, scale, zp, lo, hi, ste)
            dx_k = fake_quant_backward(x, scale, zp, gy, lo, hi, ste, sums=False)[0]
            dx_r = fake_quant_backward_reference(x, scale, zp, gy, lo, hi, ste)[0]
            if not (torch.equal(y_k, y_r) and torch.equal(dx_k, dx_r)):
                raise AssertionError(f"fake_quant at the view {what} (n {x.numel()}), zp "
                                     f"{zp_v} lo {lo} hi {hi} ste_clamp {ste}: forward "
                                     f"{int((y_k != y_r).sum())} and dx "
                                     f"{int((dx_k != dx_r).sum())} elements differ")
        path = "scalar loop" if vecs == 0 else "float4 body"
        print(f"[fake_quant_kernels] view {what}: n {x.numel()}, x {x.data_ptr() % 16} bytes "
              f"past a 16-byte boundary; the {path} ({vecs} float4, "
              f"{x.numel() - 4 * vecs} one at a time); 4 cases, forward and dx bit for bit")
        if what == FQ_VIEWS[0][0]:
            with torch.no_grad():
                t_k = cuda_ms(lambda: fake_quant(x, scale, 0.0, -7.0, 7.0))
            t_b = FQ_BYTES[0] * x.numel() / bw * 1e3
            rows.append(dict(kernel="fake_quant", shape=[x.numel()], view=what, ms=t_k,
                             bound_ms=t_b, bound_by="bytes"))
            print(f"[fake_quant_kernels] fake_quant at the view {what}, the scalar loop: "
                  f"{t_k:.4f} ms, bound {t_b:.3g} ms")
    return rows


# every float32 bit pattern, in chunks of this many (1 GiB each)
FQ_EXHAUSTIVE_CHUNK = 1 << 28
# (zero point, lo, hi): zero points 0 (passed as a number) and 3 (a tensor)
# on narrow grids, and bounds so wide that the quotient's own bits reach y
# wherever |x / s| >= 2^23
FQ_EXHAUSTIVE_GRIDS = [(0.0, -7.0, 7.0), (0.0, 0.0, 255.0), (3.0, -7.0, 7.0),
                       (3.0, 0.0, 255.0), (0.0, -2.0 ** 30, 2.0 ** 30)]
FQ_EXHAUSTIVE_SEEDED = 8  # scales drawn log-uniformly from [1e-4, 1e2], numpy seed 14


def fq_exhaustive_scales(dev) -> list:
    """(name, one-element float32 scale on the card) for the exhaustive
    phase."""
    from brevitas_tpu_torch.models.mobilenetv1 import common_uint_act_quant
    from brevitas_tpu_torch.quant.quantizers import ActQuantizer

    def bits(b):
        return torch.tensor(b, dtype=torch.int32).view(torch.float32).to(dev)

    one = torch.ones((), device=dev)
    log_fp = ActQuantizer(common_uint_act_quant(4)).to(dev).static_int_params()[0]
    scales = [("1/7 divided on the card", one / torch.full((), 7.0, device=dev)),
              ("1.0", one), ("2^-10", torch.full((), 2.0 ** -10, device=dev)),
              ("MobileNet's LOG_FP start, 2^log2(6) / 15", log_fp.detach().reshape(())),
              ("0x3F800001", bits(0x3F800001)), ("0x3F7FFFFF", bits(0x3F7FFFFF)),
              ("0x3FFFFFFF", bits(0x3FFFFFFF)), ("FLT_MIN", bits(0x00800000)),
              ("2e-16 (scaling_min_val)", torch.full((), 2e-16, device=dev)),
              ("1e30", torch.full((), 1e30, device=dev))]
    rng = np.random.default_rng(14)
    drawn = np.exp(rng.uniform(np.log(1e-4), np.log(1e2), FQ_EXHAUSTIVE_SEEDED))
    scales += [(f"seeded {float(v):.9g}", torch.tensor(v, device=dev))
               for v in drawn.astype(np.float32)]
    return scales


def phase_fake_quant_exhaustive(dev) -> dict:
    """fake_quant's forward against fake_quant_reference on the card over
    every float32 bit pattern (2^32, in chunks made on the card), at every
    scale of fq_exhaustive_scales and every grid of FQ_EXHAUSTIVE_GRIDS: the
    same bits everywhere, a NaN compared only as a NaN. Raises on any
    difference."""
    from brevitas_tpu_torch.kernels import fake_quant, fake_quant_reference

    t0 = time.perf_counter()
    scales = fq_exhaustive_scales(dev)
    grids = [(torch.full((), zp, device=dev) if zp else zp, lo, hi)
             for zp, lo, hi in FQ_EXHAUSTIVE_GRIDS]
    compared, faults = 0, []
    with torch.no_grad():
        for start in range(0, 1 << 32, FQ_EXHAUSTIVE_CHUNK):
            signed = start - (1 << 32) if start >= 1 << 31 else start
            x = torch.arange(signed, signed + FQ_EXHAUSTIVE_CHUNK, dtype=torch.int64,
                             device=dev).to(torch.int32).view(torch.float32)
            for name, s in scales:
                for zp, lo, hi in grids:
                    y_k = fake_quant(x, s, zp, lo, hi)
                    y_r = fake_quant_reference(x, s, zp, lo, hi)
                    bits_k, bits_r = y_k.view(torch.int32), y_r.view(torch.int32)
                    compared += x.numel()
                    if torch.equal(bits_k, bits_r):
                        continue
                    differ = (bits_k != bits_r) & ~(torch.isnan(y_k) & torch.isnan(y_r))
                    n_diff = int(differ.sum())
                    if n_diff:
                        i = int(differ.nonzero()[0])
                        faults.append(dict(scale=name, zero_point=float(zp), lo=lo, hi=hi,
                                           differ=n_diff, x_bits=hex(start + i),
                                           kernel=float(y_k[i]), plain=float(y_r[i])))
                    del differ
            del x, y_k, y_r, bits_k, bits_r
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = {"scales": [name for name, _ in scales],
           "scale_values": [float(s) for _, s in scales], "grids": FQ_EXHAUSTIVE_GRIDS,
           "compared": compared, "differing": sum(f["differ"] for f in faults),
           "faults": faults[:20], "seconds": seconds}
    print(f"[fake_quant_exhaustive] every float32 bit pattern through the kernel and "
          f"fake_quant_reference on the card, {len(scales)} scales x {len(grids)} grids: "
          f"{compared} elements compared, {out['differing']} differ, in {seconds:.1f} s")
    if faults:
        raise AssertionError(f"fake_quant differs from its plain version: {faults[:5]}")
    return out


FQ_SPREAD_REPS = 7  # alternating kernel / library measurements of each step's forward
FQ_SPREAD_WINDOWS = 9  # cuda_ms windows of each measurement (its median)


def phase_fake_quant_spread(dev) -> dict:
    """fake_quant's forward over one lfc_qat, cnv_qat and mobilenet_qat step
    (FQ_STEPS, in the path's case) against
    torch.fake_quantize_per_tensor_affine on the same inputs, FQ_SPREAD_REPS
    times each, alternating: for each step the medians of the two step sums
    and the spread (max - min) of each, so that a difference can be told
    from the drift between runs."""
    from brevitas_tpu_torch.kernels import fake_quant

    g = torch.Generator(device=dev).manual_seed(6)
    scale = torch.ones((), device=dev) / torch.full((), 7.0, device=dev)
    s_host = float(scale)
    inputs = {step: [(torch.randn(sh, generator=g, device=dev), n) for sh, n, _ in shapes]
              for step, shapes in FQ_STEPS.items()}
    kern = {step: [] for step in inputs}
    lib = {step: [] for step in inputs}
    with torch.no_grad():
        for _ in range(FQ_SPREAD_REPS):
            for step, xs in inputs.items():
                kern[step].append(sum(
                    n * cuda_ms(lambda x=x: fake_quant(x, scale, 0.0, -7.0, 7.0),
                                reps=FQ_SPREAD_WINDOWS) for x, n in xs))
                lib[step].append(sum(
                    n * cuda_ms(lambda x=x: torch.fake_quantize_per_tensor_affine(
                        x, s_host, 0, -7, 7), reps=FQ_SPREAD_WINDOWS) for x, n in xs))
    out = {}
    for step, xs in inputs.items():
        o = {"reps": FQ_SPREAD_REPS, "launches": sum(n for _, n in xs),
             "kernel_ms": kern[step], "library_ms": lib[step],
             "kernel_median": statistics.median(kern[step]),
             "library_median": statistics.median(lib[step]),
             "kernel_spread": max(kern[step]) - min(kern[step]),
             "library_spread": max(lib[step]) - min(lib[step])}
        o["median_gap"] = o["kernel_median"] - o["library_median"]
        o["ratio"] = o["kernel_median"] / o["library_median"]
        beyond = max(o["kernel_spread"], o["library_spread"])
        o["kernel_ahead_beyond_spread"] = -o["median_gap"] > beyond
        o["kernel_behind_beyond_spread"] = o["median_gap"] > beyond
        out[step] = o
        print(f"[fake_quant_spread] one {step} step's forward ({o['launches']} launches), "
              f"{FQ_SPREAD_REPS} alternating runs on {CARD[0]}: kernel median "
              f"{o['kernel_median']:.5f} ms (spread {o['kernel_spread']:.5f}), "
              f"torch.fake_quantize_per_tensor_affine median {o['library_median']:.5f} ms "
              f"(spread {o['library_spread']:.5f}); kernel / library {o['ratio']:.4f}, gap "
              f"{o['median_gap']:.5f} ms; ahead beyond both spreads "
              f"{o['kernel_ahead_beyond_spread']}, behind beyond them "
              f"{o['kernel_behind_beyond_spread']}")
    return out


def fake_quant_step_sums(rows, name, step_shapes) -> dict:
    """A fake_quant kernel's times over one training step: its launches at
    the step's shapes."""
    idx = 1 if name == "fake_quant" else 2
    per_shape = {tuple(r["shape"]): r for r in rows if r["kernel"] == name and "view" not in r}
    keys = ("ms", "plain_ms", "library_ms", "bound_ms") + (
        ("ms_with_sums",) if name == "fake_quant_backward" else ())
    sums = {key: sum(per_shape[sh][key] * sh_n[idx - 1] for sh, *sh_n in step_shapes)
            for key in keys}
    sums["launches_per_step"] = sum(c[idx] for c in step_shapes)
    return sums


def fake_quant_summary(rows, name, launches) -> dict:
    """A fake_quant kernel's row: its times over one lfc_qat step, and over
    one cnv_qat and one mobilenet_qat step beside them."""
    sums = fake_quant_step_sums(rows, name, FQ_STEP_SHAPES)
    per_step = sums.pop("launches_per_step")
    entry = {
        "name": name, "route": "cuda", "source": "brevitas_tpu_torch/csrc/fake_quant.cu",
        "replaces": "brevitas_tpu/kernels/fake_quant.py:110", "launches": launches,
        "max_abs_err": 0.0, **sums, "bound_by": "bytes",
        "per": f"one lfc_qat step at batch {LFC_QAT_BATCH}: {per_step} launches",
        "cnv_qat_step": fake_quant_step_sums(rows, name, CNV_FQ_STEP_SHAPES),
        "mobilenet_qat_step": fake_quant_step_sums(rows, name, MOBILENET_FQ_STEP_SHAPES),
        "library_note": "torch.fake_quantize_per_tensor_affine (forward) and the backward of "
                        "torch._fake_quantize_learnable_per_tensor_affine multiply by 1/s: they "
                        "compute the Pallas kernel's function, not the port's",
        "scale_sum_ratio": max(r["scale_sum_ratio"] for r in rows if "view" not in r),
    }
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


@contextlib.contextmanager
def recorded_fake_quant_calls(store: list):
    """Append (shape, whether a backward follows) of each call of the
    quantizers' per-tensor fake-quant to ``store``."""
    from brevitas_tpu_torch.quant import quantizers

    saved = quantizers.fake_quant

    def recording(x, scale, zero_point, *args, **kw):
        grad = torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in (x, scale, zero_point))
        store.append((tuple(x.shape), grad))
        return saved(x, scale, zero_point, *args, **kw)

    quantizers.fake_quant = recording
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


def phase_lfc_qat(dev, bf16: bool, bits=(4, 4, 4), fq=LFC_QAT_FQ, name="lfc_qat") -> dict:
    """bench's lfc_int4_qat step at full width through the port's trainer
    step (examples.bnn_pynq.train_step), a warm-up and LFC_QAT_STEPS timed
    steps, in bf16 operands (bench's default) or float32; ``bits`` (weight,
    act, input) and ``fq`` (fake_quant launches a step, forward and
    backward) run the same step at other widths (binary_qat). A copy on the card
    runs the plain chain in every quantizer: the warm-up step's loss and
    every gradient the same bits; each later step's loss difference
    reported. A CPU copy's first loss within LFC_QAT_CPU_LOSS_RTOL (BatchNorm
    and TensorNorm sum in another order on the CPU)."""
    from brevitas_tpu_torch.examples import bnn_pynq
    from brevitas_tpu_torch.models import lfc
    from brevitas_tpu_torch.utils import set_compute_dtype

    what = f"{name}_{'bf16' if bf16 else 'float32'}"
    gc.collect()
    model = lfc(*bits, dropout=0.0, generator=torch.Generator().manual_seed(0), device=dev)
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
    fq_want = {"fake_quant": fq[0], "fake_quant_backward": fq[1]}
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


# bench.py's cnv_int4pc_qat and cnv_int8pc_qat legs (bench.py:403-424,
# _scanned_train :226-262): cnv(bits, bits, 8, per_channel_weights=True), at
# batch 256 on (32, 32, 3) images drawn as _scanned_train draws them and
# transposed to NCHW, the square hinge loss, Adam lr 1e-3, clip_weights(-1,
# 1); one scanned epoch is 10 steps
CNV_QAT_BITS = (4, 8)
CNV_QAT_BATCH = 256
CNV_QAT_STEPS = 10
CNV_QAT_LR = 1e-3
# the card's first loss against a CPU copy's, the copy's activation codes set
# to the card's where they differ at a certified .5 tie (CNV_TIE_SHARE): in
# float32 the convs of fake-quant values sum in another order on the CPU, so a
# code may flip at a tie, and each flip would move one image's logits; what
# is left differs in float32 rounding (TensorNorm's sums)
CNV_QAT_CPU_LOSS_RTOL = 1e-5
# a code of the CPU copy may differ from the card's only where the two inputs
# to its quantizer lie on either side of the same half-integer boundary,
# within this share of the tensor's largest value of each other
CNV_TIE_SHARE = 1e-5
# fake_quant launches a step: the input quantizer and the 8 activation
# quantizers forward (the per-channel weights take the plain chain); the
# backward of all but the input quantizer, whose input, the data, needs no
# gradient
CNV_QAT_FQ = (9, 8)
# the trainer's CNV_4W4A (const-scale per-tensor weights): its 9 weight
# quantizers launch both ways as well
CNV_TRAINER_FQ = (18, 17)
# a float32 conv under TF32 allowed process-wide (cuDNN's flag and the
# float32 matmul precision "high"), against a float64 one: x codes 1..7 and
# w = m (1 + 2^-12) for m in 1..7, all positive, so every product loses 2^-12
# of itself where an operand is rounded to TF32's 10 mantissa bits, and the
# float32 sums stay within K 2^-24 of themselves, K the terms a sum (at most
# 576 here)
TF32_GUARD_SHAPE = (2, 64, 8, 8)
# CNV's six convs at batch 256: (in channels, out channels, input size)
CNV_CONV_SHAPES = [(3, 64, 32), (64, 64, 30), (64, 128, 14), (128, 128, 12), (128, 256, 5),
                   (256, 256, 3)]


def check_convs(dev) -> dict:
    """The port's conv (nn.conv.conv_nd: a patch matrix times the weight
    matrix in float32) on the card. (1) In full float32 with TF32 allowed
    process-wide: a QuantConv2d's output, input gradient and weight
    gradient within K 2^-24 of a float64 conv's (see TF32_GUARD_SHAPE; TF32
    would miss by 2^-12), cuDNN's F.conv2d under the same flags printed
    beside it. (2) Exact on integer codes at CNV's conv shapes
    (CNV_CONV_SHAPES, codes in -7..7 and the input's 8-bit codes at the
    first conv), forward, input and weight gradients, as the code-domain
    branch needs; cuDNN's F.conv2d and its backward, TF32 off, counted
    beside it, and both timed (forward and backward, the card kept
    busy)."""
    from brevitas_tpu_torch.nn import QuantConv2d
    from brevitas_tpu_torch.nn.conv import conv_nd

    n, c, h, w = TF32_GUARD_SHAPE
    gen = torch.Generator(device=dev).manual_seed(3)
    conv = QuantConv2d(c, c, 3, padding="VALID", use_bias=False, weight_quant=None, device=dev)
    tf32_step = 1.0 + 2.0 ** -12

    def draw(shape, lo=1, hi=8, scale=1.0):
        return torch.randint(lo, hi, shape, generator=gen, device=dev).float() * scale

    with torch.no_grad():
        conv.weight.copy_(draw(conv.weight.shape, scale=tf32_step))
    x = draw((n, c, h, w)).requires_grad_()
    gy = draw((n, c, h - 2, w - 2), scale=tf32_step)
    saved = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        y = conv(x)
        dx, dw = torch.autograd.grad(y, (x, conv.weight), gy)
        with torch.no_grad():
            control = torch.nn.functional.conv2d(x, conv.weight)
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    x64 = x.detach().double().requires_grad_()
    w64 = conv.weight.detach().double().requires_grad_()
    y64 = torch.nn.functional.conv2d(x64, w64)
    dx64, dw64 = torch.autograd.grad(y64, (x64, w64), gy.double())
    out = {}
    for name, got, want, terms in (("y", y, y64, c * 9), ("dx", dx, dx64, c * 9),
                                   ("dw", dw, dw64, n * (h - 2) * (w - 2)),
                                   ("cudnn_y", control, y64, c * 9)):
        rel = float(((got.detach().double() - want.detach()).abs() / want.detach()).max())
        out[name] = rel
        if not name.startswith("cudnn") and rel > terms * 2.0 ** -24:
            raise AssertionError(f"convs: the conv's {name} under TF32 allowed is {rel:.3g} "
                                 f"from float64, over {terms} * 2^-24")
    print(f"[convs] TF32 allowed process-wide: the module's conv is float32 (largest share of "
          f"float64 off: y {out['y']:.3g}, dx {out['dx']:.3g}, dw {out['dw']:.3g}; TF32 would "
          f"be {2.0 ** -12:.3g}); cuDNN's F.conv2d under the same flags: {out['cudnn_y']:.3g}")

    out["exact"] = []
    for cin, cout, size in CNV_CONV_SHAPES:
        lo, hi = (-128, 128) if cin == 3 else (-7, 8)
        xc = draw((CNV_QAT_BATCH, cin, size, size), lo, hi).requires_grad_()
        wc = draw((cout, cin, 3, 3), -7, 8).requires_grad_()
        gc_ = draw((CNV_QAT_BATCH, cout, size - 2, size - 2), -7, 8)
        x64, w64 = xc.detach().double(), wc.detach().double()
        want = torch.ops.aten.convolution_backward(gc_.double(), x64, w64, None, [1, 1],
                                                   [0, 0], [1, 1], False, [0, 0], 1,
                                                   [True, True, False])[:2]
        want = (torch.nn.functional.conv2d(x64, w64),) + want
        pads = ((0, 0), (0, 0))

        def port_conv():
            yv = conv_nd(xc, wc, (1, 1), pads, (1, 1))
            return (yv,) + torch.autograd.grad(yv, (xc, wc), gc_)

        def cudnn_conv():
            yv = torch.nn.functional.conv2d(xc, wc)
            return (yv,) + torch.autograd.grad(yv, (xc, wc), gc_)

        port, cudnn = port_conv(), cudnn_conv()
        torch.cuda.synchronize()
        inexact = [int((a.double() != b).sum()) for a, b in zip(port, want)]
        cudnn_inexact = [int((a.double() != b).sum()) for a, b in zip(cudnn, want)]
        row = {"shape": [CNV_QAT_BATCH, cin, size, size, cout], "inexact": inexact,
               "cudnn_inexact": cudnn_inexact, "ms": cuda_ms(port_conv, reps=10, inner=3),
               "cudnn_ms": cuda_ms(cudnn_conv, reps=10, inner=3)}
        out["exact"].append(row)
        print(f"[convs] {cin} -> {cout} at {size} x {size}, batch {CNV_QAT_BATCH}: the port's "
              f"conv forward, dx, dw inexact in {inexact} elements, cuDNN's in "
              f"{cudnn_inexact} (of {[v.numel() for v in want]}); forward and backward "
              f"{row['ms']:.4f} ms, cuDNN {row['cudnn_ms']:.4f} ms, on {CARD[0]}")
        if any(inexact):
            raise AssertionError(f"convs: integer sums inexact at {row['shape']}: {inexact}")
    return out


def cnv_act_quantizers(model):
    """CNV's activation quantizers in forward order: the input's, then the
    eight after its BatchNorms."""
    from brevitas_tpu_torch.nn import QuantIdentity

    return [model.input_quant] + [m for m in [*model.conv_features, *model.linear_features]
                                  if isinstance(m, QuantIdentity)]


@contextlib.contextmanager
def recorded_act_codes(model, store: list, quantizers=None):
    """Forward hooks that keep each activation quantizer's input and output
    value, in call order (``quantizers``: the layers to hook, CNV's by
    default; a layer called twice a forward records twice)."""
    def hook(mod, args, out):
        x = args[0].value if hasattr(args[0], "value") else args[0]
        store.append((x.detach(), out.value.detach()))

    quantizers = cnv_act_quantizers(model) if quantizers is None else quantizers
    handles = [q.register_forward_hook(hook) for q in quantizers]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def forced_act_codes(model, want: list, flips: list, quantizers=None):
    """Forward hooks on a CPU copy: each activation quantizer's output where
    it differs from the card's (``want``, from recorded_act_codes with the
    same ``quantizers``) must be a certified .5 tie (CNV_TIE_SHARE), and then
    takes the card's value, so the rest of the forward sees the card's
    codes. Appends the count to ``flips``, one entry a call."""
    from brevitas_tpu_torch.quant_tensor import QuantTensor

    def hook(mod, args, out):
        i = len(flips)
        want_x, want_y = (v.cpu() for v in want[i])
        got_x = (args[0].value if hasattr(args[0], "value") else args[0]).detach()
        got_y = out.value.detach()
        differ = got_y != want_y
        flips.append(int(differ.sum()))
        if not flips[-1]:
            return out
        # a per-channel scale broadcasts over its channel axis
        s = torch.broadcast_to(out.scale.detach(), got_y.shape)[differ]
        c_got, c_want = torch.round(got_y[differ] / s), torch.round(want_y[differ] / s)
        half = (c_got + c_want) / 2
        ok = (((c_got - c_want).abs() == 1)
              & ((got_x[differ] / s - half) * (want_x[differ] / s - half) <= 0)
              & ((got_x[differ] - want_x[differ]).abs() <= CNV_TIE_SHARE * want_x.abs().max()))
        if not bool(ok.all()):
            raise AssertionError(f"act codes: quantizer call {i}: {int((~ok).sum())} codes of "
                                 "the CPU copy differ from the card's away from a .5 tie")
        return QuantTensor(want_y, out.scale, out.zero_point, out.bit_width, signed=out.signed,
                           training=out.training)

    quantizers = cnv_act_quantizers(model) if quantizers is None else quantizers
    handles = [q.register_forward_hook(hook) for q in quantizers]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def phase_cnv_qat(dev, bits: int, bf16: bool, per_channel: bool = True, fq=CNV_QAT_FQ,
                  name=None) -> dict:
    """bench's cnv_int{bits}pc_qat step at full width through the port's
    trainer step (examples.bnn_pynq.train_step), a warm-up and CNV_QAT_STEPS
    timed steps, in bf16 operands (bench's default) or float32;
    ``per_channel`` False runs the trainer's const-scale weights (binary_qat's
    cnv(2, 2, 8)), with ``fq`` fake_quant launches a step. A copy on
    the card runs the plain chain in every quantizer: the warm-up's loss and
    every gradient the same bits, each later step's loss difference
    reported. The path calls no cuDNN (the convs are a patch matrix times
    the weights at the highest float32 matmul precision, which they take
    themselves), so cuDNN's determinism flag governs nothing here; every
    step runs under the default flags. A CPU copy's first loss within
    CNV_QAT_CPU_LOSS_RTOL, its activation codes set to the card's where they
    differ at certified .5 ties (forced_act_codes)."""
    from brevitas_tpu_torch.examples import bnn_pynq
    from brevitas_tpu_torch.models import cnv
    from brevitas_tpu_torch.utils import set_compute_dtype

    what = f"{name or f'cnv_qat_int{bits}pc'}_{'bf16' if bf16 else 'float32'}"
    gc.collect()
    model = cnv(bits, bits, 8, per_channel_weights=per_channel,
                generator=torch.Generator().manual_seed(0), device=dev)
    if bf16:
        set_compute_dtype(model, torch.bfloat16)
    plain = copy.deepcopy(model)
    cpu_model = copy.deepcopy(model).to("cpu")
    # the data as bench.py's _scanned_train draws it, in NCHW
    rng = np.random.default_rng(0)
    xs_np = np.ascontiguousarray(rng.random(
        (CNV_QAT_STEPS, CNV_QAT_BATCH, 32, 32, 3), dtype=np.float32).transpose(0, 1, 4, 2, 3))
    ys_np = rng.integers(0, 10, (CNV_QAT_STEPS, CNV_QAT_BATCH)).astype(np.int32)
    xs, ys = torch.from_numpy(xs_np).to(dev), torch.from_numpy(ys_np).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=CNV_QAT_LR)
    plain_opt = torch.optim.Adam(plain.parameters(), lr=CNV_QAT_LR)

    # the warm-up step on both paths: the same loss and gradient bits
    card_codes = []
    _reset_launch_counts()
    with recorded_act_codes(model, card_codes):
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
    flips = []
    with torch.no_grad(), forced_act_codes(cpu_model, card_codes, flips):
        cpu_loss = float(bnn_pynq.sqr_hinge_loss(cpu_model(torch.from_numpy(xs_np[0])),
                                                 torch.from_numpy(ys_np[0])))
    del card_codes
    cpu_dev = abs(float(loss0) - cpu_loss) / abs(cpu_loss)
    print(f"[{what}] warm-up step: loss {float(loss0)} the same bits as "
          f"the plain chain's, all {len(plain_params)} gradients the same bits; CPU copy's "
          f"loss {cpu_loss} (relative {cpu_dev:.3g}) with {sum(flips)} codes set to the card's "
          f"at certified ties (by quantizer {flips}); launches {warm_counts}")
    if cpu_dev > CNV_QAT_CPU_LOSS_RTOL:
        raise AssertionError(f"{what}: the card's first loss is {cpu_dev:.3g} from a CPU copy's")
    fq_want = {"fake_quant": fq[0], "fake_quant_backward": fq[1]}
    if any(warm_counts[k] != v for k, v in fq_want.items()):
        raise AssertionError(f"{what}: fake_quant launches {warm_counts}, expected {fq_want}")

    # the timed steps: one scanned epoch of bench, under the same flags
    flags = {"float32_matmul_precision (process; the convs take 'highest')":
             torch.get_float32_matmul_precision()}
    torch.cuda.synchronize()
    _reset_launch_counts()
    t0 = time.perf_counter()
    losses = [bnn_pynq.train_step(model, opt, xs[i], ys[i]) for i in range(CNV_QAT_STEPS)]
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    counts = _launch_counts()
    _record_path(what, {k: v + warm_counts[k] for k, v in counts.items()})
    want = {k: CNV_QAT_STEPS * fq_want.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts} over {CNV_QAT_STEPS} steps, "
                             f"expected {want}")
    with plain_fake_quant():
        plain_losses = [bnn_pynq.train_step(plain, plain_opt, xs[i], ys[i])
                        for i in range(CNV_QAT_STEPS)]
    losses = [float(v) for v in losses]
    plain_losses = [float(v) for v in plain_losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: losses {losses}")
    step_dev = [abs(a - b) for a, b in zip(losses, plain_losses)]
    clip = max(float(lyr.weight.detach().abs().max()) for lyr in model.modules()
               if hasattr(lyr, "weight_quant"))
    if clip > 1.0:
        raise AssertionError(f"{what}: a weight outside [-1, 1] after clip_weights: {clip}")
    ms = total_ms / CNV_QAT_STEPS
    out = {"compute_dtype": "bf16" if bf16 else "float32", "bits": bits, "ms_per_step": ms,
           "images_per_s": CNV_QAT_BATCH / ms * 1e3, "losses": losses,
           "first_loss": float(loss0), "cpu_first_loss_rel_dev": cpu_dev,
           "cpu_tie_flips": flips,
           "loss_dev_per_step": step_dev, "timed_flags": flags,
           "fake_quant_per_step": counts["fake_quant"] / CNV_QAT_STEPS,
           "fake_quant_backward_per_step": counts["fake_quant_backward"] / CNV_QAT_STEPS}
    print(f"[{what}] {CNV_QAT_STEPS} steps: {ms:.3f} ms per step (host clock over the epoch, "
          f"synchronized at its end), {out['images_per_s']:.0f} images/s, "
          f"{out['compute_dtype']} operands, flags {flags}, on {CARD[0]}; fake_quant launches "
          f"per step {out['fake_quant_per_step']:g} forward, "
          f"{out['fake_quant_backward_per_step']:g} backward; kernel path vs plain chain: loss "
          f"|diff| per step max {max(step_dev):.3g} ({step_dev})")

    def one_step():
        bnn_pynq.train_step(model, opt, xs[0], ys[0])
        torch.cuda.synchronize()

    out["profile"] = profile_steps(one_step, what, "training step", n=3, grad=True)
    print(f"[{what}] device busy {out['profile']['busy_ms']:.4f} ms a step, idle share "
          f"{out['profile']['idle_share']:.3f}, {out['compute_dtype']} operands, on {CARD[0]}")
    return out


def phase_bnn_pynq(dev) -> dict:
    """The trainer's entry point on the card: examples.bnn_pynq.main on
    synthetic data for one epoch (run_trainer), LFC_4W4A and CNV_4W4A."""
    return {network: run_trainer(["--network", network], fq,
                                 "bnn_pynq" if network == "LFC_4W4A"
                                 else f"bnn_pynq_{network.lower()}", dev)
            for network, fq in (("LFC_4W4A", LFC_QAT_FQ), ("CNV_4W4A", CNV_TRAINER_FQ))}


def run_trainer(argv, fq, path: str, dev) -> dict:
    """examples.bnn_pynq.main on synthetic data for one epoch (20 steps at
    batch 100, then the evaluation of 512 images in 2 batches), its
    checkpoint in a temporary directory, its launches counted against ``fq``
    (fake_quant launches a step, forward and backward; the evaluation
    launches the forward's)."""
    import tempfile

    from brevitas_tpu_torch.examples import bnn_pynq

    _reset_launch_counts()
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        acc = bnn_pynq.main(argv + ["--dataset", "synthetic", "--epochs", "1", "--device",
                                    str(dev), "--ckpt-dir", ckpt])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        saved = sorted(os.listdir(ckpt))
    counts = _launch_counts()
    _record_path(path, counts)
    steps, evals = 2048 // 100, 2
    want = {k: 0 for k in counts}
    want.update(fake_quant=fq[0] * (steps + evals), fake_quant_backward=fq[1] * steps)
    print(f"[{path}] main {argv}: val acc {acc} (synthetic labels: chance), "
          f"{seconds:.2f} s with the evaluation, checkpoint {saved}, launches {counts}")
    if counts != want:
        raise AssertionError(f"{path}: launches {counts}, expected {want}")
    if not 0.0 <= acc <= 1.0:
        raise AssertionError(f"{path}: accuracy {acc}")
    return {"val_acc": acc, "launches": counts, "seconds": seconds, "checkpoint": saved}


# the trainer's reference defaults and shipped 1- and 2-bit configs: fake_quant
# launches a step (forward, backward). LFC_1W1A is binary throughout; LFC_1W2A
# quantizes its 2-bit input and three activations (the input needs no
# gradient); CNV_1W1A's only INT quantizer is its 8-bit input; CNV_2W2A's nine
# const-scale weights, 8 activations and input are all per-tensor INT
BINARY_TRAINER_RUNS = [("default LFC_1W1A", [], (0, 0)), ("lfc_1w2a", ["--cfg", "lfc_1w2a"], (4, 3)),
                       ("cnv_1w1a", ["--cfg", "cnv_1w1a"], (1, 0)),
                       ("cnv_2w2a", ["--cfg", "cnv_2w2a"], (18, 17))]


def phase_bnn_pynq_binary(dev) -> dict:
    """The trainer's main at its reference default (no --network: LFC_1W1A)
    and with --cfg lfc_1w2a, cnv_1w1a and cnv_2w2a."""
    return {name: run_trainer(argv, fq, f"bnn_pynq_binary_{name.split()[-1].lower()}", dev)
            for name, argv, fq in BINARY_TRAINER_RUNS}


# bench's lfc_qat and cnv_qat steps at the 1- and 2-bit widths of the shipped
# configs: lfc(1, 2, 2) at batch 1024 and cnv(2, 2, 8) with const-scale weights
# at batch 256; fake_quant launches a step (forward, backward)
BINARY_QAT_LFC = ((1, 2, 2), (4, 3))
BINARY_QAT_CNV = (2, (18, 17))


def phase_binary_qat(dev) -> dict:
    out = {}
    for d in ("bf16", "float32"):
        out[f"lfc_1w2a_{d}"] = phase_lfc_qat(dev, d == "bf16", bits=BINARY_QAT_LFC[0],
                                             fq=BINARY_QAT_LFC[1], name="binary_qat_lfc_1w2a")
        out[f"cnv_2w2a_{d}"] = phase_cnv_qat(dev, BINARY_QAT_CNV[0], d == "bf16",
                                             per_channel=False, fq=BINARY_QAT_CNV[1],
                                             name="binary_qat_cnv_2w2a")
    return out


QO_SHAPE = (1024, 1024)
QO_TWO_PHASE_STEPS, QO_TWO_PHASE_CALLS = 3, 5
# a gradient that autograd sums over the tensor (a scale's, a zero point's, a
# learned bit width's, an input's through the statistics): the card against
# its CPU copy within this share of sum |g| (1 + max |x|), the size of the
# parts such a sum adds (ROADMAP S8: 6e-4 of sum |term| for float32 autograd
# sums over a million elements)
QO_GRAD_RTOL = 6e-4


def quant_option_cases():
    """name -> (side, config, (fake_quant, fake_quant_backward) launches of
    one call whose input needs a gradient)."""
    from brevitas_tpu_torch.quant import presets
    from brevitas_tpu_torch.quant.config import ScalingImplType, ZeroPointImplType

    int8w = presets.Int8WeightPerTensorFloat
    zp_act = presets.Uint8ActPerTensorFloat.let(scaling_impl=ScalingImplType.CONST,
                                                scaling_const=2.0,
                                                zero_point_impl=ZeroPointImplType.PARAMETER)
    return {
        "round_to_zero": ("weight", int8w.let(float_to_int="round_to_zero"), (0, 0)),
        "dpu_round": ("weight", int8w.let(float_to_int="dpu_round", bit_width=3.0), (0, 0)),
        "int_restrict": ("weight", int8w.let(scaling_impl=ScalingImplType.PARAMETER,
                                             scaling_const=3.3, restrict_scaling="int"), (1, 1)),
        "shifted_weight": ("weight", presets.ShiftedUint8WeightPerTensorFloat, (1, 1)),
        "shifted_weight_per_channel": ("weight", presets.ShiftedUint8WeightPerChannelFloat,
                                       (0, 0)),
        "zp_parameter": ("act", zp_act, (1, 1)),
        "zp_parameter_quantized": ("act", zp_act.let(quantize_zero_point=True), (1, 1)),
        "learned_bit_width_weight": ("weight", presets.Int8WeightPerTensorFloatLearnedBitWidth,
                                     (0, 0)),
        "learned_bit_width_act": ("act", presets.Int8ActPerTensorFloatLearnedBitWidth, (0, 0)),
        "stochastic_round": ("act", presets.Int8ActPerTensorFloat.let(
            float_to_int="stochastic_round", scaling_impl=ScalingImplType.CONST,
            scaling_const=1.5, bit_width=4.0), (0, 0)),
    }


def _quant_call(q, x, g):
    """One call with a gradient: (output QuantTensor, input gradient,
    parameter gradients)."""
    x = x.detach().clone().requires_grad_()
    for p in q.parameters():
        p.grad = None
    qt = q(x)
    (qt.value * g).sum().backward()
    return qt, x.grad, {n: None if p.grad is None else p.grad.detach().clone()
                        for n, p in q.named_parameters()}


def _same(a, b) -> bool:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return torch.equal(a.detach().cpu().reshape(-1), b.detach().cpu().reshape(-1))


def _check_quant_call(what, card, cpu, x, g, bits_grads=False) -> float:
    """The card's call against its CPU copy's: values, scale, zero point and
    bit width bit for bit; gradients within QO_GRAD_RTOL of their parts.
    Returns the worst gradient difference as a share of that size."""
    (qt, dx, grads), (qt_c, dx_c, grads_c) = card, cpu
    for name, a, b in (("value", qt.value, qt_c.value), ("scale", qt.scale, qt_c.scale),
                       ("zero point", qt.zero_point, qt_c.zero_point),
                       ("bit width", qt.bit_width, qt_c.bit_width)):
        if not _same(a, b):
            raise AssertionError(f"quant_options {what}: the {name} differs from the CPU copy's")
    size = float(g.abs().sum()) * (1.0 + float(x.abs().max()))
    worst = float((dx.cpu() - dx_c).abs().max()) / size
    for n, v in grads.items():
        v_c = grads_c[n]
        if (v is None) != (v_c is None):
            raise AssertionError(f"quant_options {what}: {n} has a gradient on one side only")
        if v is not None:
            worst = max(worst, float((v.cpu() - v_c).abs().max()) / size)
    if worst > QO_GRAD_RTOL:
        raise AssertionError(f"quant_options {what}: a gradient differs from the CPU copy's by "
                             f"{worst:.3g} of sum |g| (1 + max |x|)")
    return worst


def check_learned_zp_sums(dev, q, x, g) -> dict:
    """The learned zero point's dzp from the backward kernel against the
    plain chain's autograd sum on the card, both against the float64 sum of
    the per-element terms: the kernel within FQ_SUM_RTOL of sum |term|, the
    autograd sum within QO_GRAD_RTOL (ROADMAP S8)."""
    from brevitas_tpu_torch.kernels import fake_quant_backward, fake_quant_backward_reference
    from brevitas_tpu_torch.kernels.fake_quant import fake_quant_scale_terms
    from brevitas_tpu_torch.ops import max_int, min_int

    with torch.no_grad():
        qt = q(x)
    cfg = q.cfg
    lo, hi = min_int(cfg.signed, cfg.narrow_range, 8.0), max_int(cfg.signed, cfg.narrow_range, 8.0)
    scale, zp = qt.scale.detach().reshape(()), qt.zero_point.detach().reshape(())
    _, _, dz_k = fake_quant_backward(x, scale, zp, g, lo, hi)
    _, _, dz_a = fake_quant_backward_reference(x, scale, zp, g, lo, hi)
    _, dz_terms, _ = fake_quant_scale_terms(x, scale, zp, g, lo, hi)
    torch.cuda.synchronize()
    exact, mass = float(dz_terms.sum()), float(dz_terms.abs().sum())
    out = {"dzp_kernel": float(dz_k), "dzp_autograd": float(dz_a), "dzp_f64": exact,
           "sum_abs_terms": mass, "kernel_share": abs(float(dz_k) - exact) / mass,
           "autograd_share": abs(float(dz_a) - exact) / mass,
           "clamped": int((dz_terms != 0).sum())}
    if out["kernel_share"] > FQ_SUM_RTOL or out["autograd_share"] > QO_GRAD_RTOL:
        raise AssertionError(f"quant_options: learned zero point's dzp {out}")
    return out


def phase_quant_options(dev) -> dict:
    """Each quantizer option of slice 8 at QO_SHAPE on the card against the
    same module copied to the CPU (one call with a gradient), its launches
    counted; the learned zero point's dzp sums; and the two-phase zero point
    (ShiftedUint8ActPerTensorFloat at QO_TWO_PHASE_STEPS collection steps)
    over QO_TWO_PHASE_CALLS training calls through its handoff, then in
    eval, with its state, against a CPU copy."""
    from brevitas_tpu_torch.quant import presets
    from brevitas_tpu_torch.quant.quantizers import ActQuantizer, ParameterQuantizer

    rng = np.random.default_rng(21)
    out = {}
    for i, (name, (side, cfg, fq)) in enumerate(quant_option_cases().items()):
        x = torch.from_numpy((rng.standard_normal(QO_SHAPE) * 1.3 + 0.2).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal(QO_SHAPE).astype(np.float32))
        q = ParameterQuantizer(cfg, x) if side == "weight" else ActQuantizer(cfg)
        with torch.no_grad():
            if name.startswith("zp_parameter"):
                q.zero_point.value.fill_(0.37)
            if name.startswith("learned_bit_width"):
                q.bit_width_impl.offset.fill_(3.4)  # round(|3.4| + 2) = 5 bits
        card = copy.deepcopy(q).to(dev)
        if name == "stochastic_round":
            # the same noise on both sides: the generators of the card and
            # the CPU draw different streams
            noise = torch.from_numpy(rng.random(QO_SHAPE, dtype=np.float32))
            q.float_to_int.noise = lambda v: noise
            card.float_to_int.noise = lambda v, n=noise.to(dev): n
        xd, gd = x.to(dev), g.to(dev)
        _reset_launch_counts()
        res = _quant_call(card, xd, gd)
        torch.cuda.synchronize()
        counts = _launch_counts()
        worst = _check_quant_call(name, res, _quant_call(q, x, g), x, g)
        got = (counts["fake_quant"], counts["fake_quant_backward"])
        if got != fq or sum(counts.values()) != sum(got):
            raise AssertionError(f"quant_options {name}: launches {counts}, expected {fq}")
        out[name] = {"launches": got, "grad_share": worst}
        if name == "zp_parameter":
            out[name]["dzp"] = check_learned_zp_sums(dev, card, xd, gd)
        print(f"[quant_options] {name} {QO_SHAPE}: value, scale, zero point and bit width bit "
              f"for bit with the CPU copy, gradients within {worst:.3g} of sum |g| (1 + max "
              f"|x|); fake_quant launches {got}" + (f"; dzp {out[name]['dzp']}"
                                                    if "dzp" in out[name] else ""))

    # the two-phase zero point through its handoff
    cfg = presets.ShiftedUint8ActPerTensorFloat.let(collect_stats_steps=QO_TWO_PHASE_STEPS)
    q = ActQuantizer(cfg)
    card = copy.deepcopy(q).to(dev)
    calls, launched = [], [0, 0]
    for i in range(QO_TWO_PHASE_CALLS):
        x = torch.from_numpy((rng.standard_normal(QO_SHAPE) * 1.3 + 0.2).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal(QO_SHAPE).astype(np.float32))
        _reset_launch_counts()
        res = _quant_call(card, x.to(dev), g.to(dev))
        torch.cuda.synchronize()
        counts = _launch_counts()
        launched = [launched[0] + counts["fake_quant"],
                    launched[1] + counts["fake_quant_backward"]]
        worst = _check_quant_call(f"two_phase call {i}", res, _quant_call(q, x, g), x, g)
        state, state_c = card.state_dict(), q.state_dict()
        differ = [k for k in state_c if not _same(state[k], state_c[k])]
        if differ:
            raise AssertionError(f"quant_options two_phase call {i}: state differs: {differ}")
        calls.append({"zero_point": float(card.zero_point.value.detach() if i >= QO_TWO_PHASE_STEPS
                                          else card.zero_point.buffer),
                      "counter": int(card.zero_point.counter), "grad_share": worst})
    card.eval()
    q.eval()
    x = torch.from_numpy((rng.standard_normal(QO_SHAPE) * 1.3 + 0.2).astype(np.float32))
    with torch.no_grad():
        ev, ev_c = card(x.to(dev)), q(x)
    if not (_same(ev.value, ev_c.value) and _same(ev.zero_point, ev_c.zero_point)):
        raise AssertionError("quant_options two_phase: eval differs from the CPU copy's")
    want = (QO_TWO_PHASE_CALLS, QO_TWO_PHASE_CALLS)
    if tuple(launched) != want:
        raise AssertionError(f"quant_options two_phase: launches {launched}, expected {want}")
    if int(card.zero_point.counter) != QO_TWO_PHASE_STEPS + 1:
        raise AssertionError("quant_options two_phase: the counter did not stop after handoff")
    out["two_phase_zero_point"] = {"calls": calls, "launches": want}
    print(f"[quant_options] two-phase zero point {QO_SHAPE}, {QO_TWO_PHASE_STEPS} collection "
          f"calls, the handoff and {QO_TWO_PHASE_CALLS - QO_TWO_PHASE_STEPS - 1} after: values, "
          f"zero points and state (buffers, values, counters) bit for bit with the CPU copy at "
          f"every call and in eval; {calls}; fake_quant launches {want}")
    return out


# bench.py's quartznet_int8_serving leg (bench.py:525-556): quartznet_15x5()
# at its published widths, batch 4, 256 frames, 64 features, random weights
# from seed 0; calibrated by one train-mode forward, then eval and
# convert_integer_inference
QN_BATCH, QN_FRAMES, QN_FEATURES = 4, 256, 64
QN_SERVED_BATCHES = 8
# after the stride-2 prologue every pointwise conv is a GEMM of M = 4 x 128
# rows; its (K, N) and how many a forward launches: the prologue's, 6 groups
# at 256 filters (5 blocks and the residual each), the widening group's
# first block and residual, the other 8 groups at 512 and the first
# epilogue, the 1 x 1 epilogue, the decoder
QN_M = QN_BATCH * QN_FRAMES // 2
QUARTZNET_KN_COUNT = {(64, 256): 1, (256, 256): 36, (256, 512): 2, (512, 512): 53,
                      (512, 1024): 1, (1024, 29): 1}
QN_INT8_PER_FORWARD = sum(QUARTZNET_KN_COUNT.values())  # 94
QN_TWINS = QN_INT8_PER_FORWARD + 77  # and 77 depthwise convs on the exact route
# fake_quant launches a forward: per block, a QuantHardTanh a separable conv,
# a QuantReLU a repeat and the shared residual quantizer twice
QN_FQ_PER_FORWARD = 2 + 15 * (5 + 5 + 2) + 2 + 1  # 185
# the exact integer route at QuartzNet's depthwise shapes and one CNV 3 x 3
# at 8 bits (whose worst case passes 2^24: float64): (name, spatial dims, in
# and out channels, kernel, stride, dilation, groups, size, batch)
EXACT_ROUTE_SHAPES = [("quartznet_k33_s2", 1, 64, 33, 2, 1, 64, 256, QN_BATCH),
                      ("quartznet_k33", 1, 256, 33, 1, 1, 256, 128, QN_BATCH),
                      ("quartznet_k75", 1, 512, 75, 1, 1, 512, 128, QN_BATCH),
                      ("quartznet_k87_d2", 1, 512, 87, 1, 2, 512, 128, QN_BATCH),
                      ("cnv_3x3_256", 2, 256, 3, 1, 1, 1, 5, 64)]


def act_layers(model):
    """A model's quantized activation layers (QuantReLU, QuantHardTanh, ...)."""
    from brevitas_tpu_torch.nn import QuantNonLinearActLayer

    return [m for m in model.modules() if isinstance(m, QuantNonLinearActLayer)]


def check_exact_route(dev) -> list:
    """Int8InferenceConv's exact integer route (nn.conv.conv_nd of the codes
    in the dtype conv_acc_dtype picks) on full-range int8 input codes and
    8-bit weight codes, against a float64 conv of the same codes on the CPU:
    equal in every element. Times the route on the card."""
    from brevitas_tpu_torch.graph.convert_int import Int8InferenceConv
    from brevitas_tpu_torch.nn import QuantConv1d, QuantConv2d
    from brevitas_tpu_torch.quant import presets

    out = []
    gen = torch.Generator(device=dev).manual_seed(5)
    for name, dims, ch, k, stride, dil, groups, size, batch in EXACT_ROUTE_SHAPES:
        pad = (k // 2) * dil if dims == 1 else 0
        conv = (QuantConv1d if dims == 1 else QuantConv2d)(
            ch, ch, k, stride=stride, dilation=dil, groups=groups,
            padding=((pad, pad),) * dims, use_bias=False,
            weight_quant=presets.Int8WeightPerChannelFloat,
            generator=torch.Generator().manual_seed(6), device=dev)
        conv.eval()
        twin = Int8InferenceConv(conv)
        x = torch.randint(-128, 128, (batch, ch) + (size,) * dims, generator=gen, device=dev,
                          dtype=torch.int8)
        got = twin._conv(x)
        torch.cuda.synchronize()
        f = torch.nn.functional.conv1d if dims == 1 else torch.nn.functional.conv2d
        want = f(x.cpu().double(), twin.w_int.cpu().double(), stride=stride,
                 padding=pad, dilation=dil, groups=groups)
        inexact = int((got.cpu().double() != want).sum())
        fan_in = conv.reduce_size
        row = {"shape": name, "fan_in": fan_in, "worst_case": fan_in * 128 * 127,
               "route": str(twin.acc_dtype).replace("torch.", ""), "inexact": inexact,
               "elements": want.numel(), "max_abs_sum": float(want.abs().max()),
               "ms": cuda_ms(lambda: twin._conv(x), reps=10, inner=3)}
        out.append(row)
        print(f"[exact_route] {name}: fan-in {fan_in}, worst case {row['worst_case']:,} "
              f"(2^24 = {2 ** 24:,}), route {row['route']}, largest |sum| "
              f"{row['max_abs_sum']:.0f}; {inexact} of {row['elements']} sums differ from a "
              f"float64 conv on the CPU; {row['ms']:.4f} ms a call on {CARD[0]}")
        if inexact:
            raise AssertionError(f"exact_route: {name}: {inexact} integer sums differ")
        want_route = "float32" if row["worst_case"] < 2 ** 24 else "float64"
        if row["route"] != want_route:
            raise AssertionError(f"exact_route: {name} took {row['route']}, not {want_route}")
    return out


def compare_quartznet_with_cpu_copy(model, x: torch.Tensor, what: str) -> dict:
    """Serve ``x`` on the card and on a CPU copy of the converted model. Each
    conv twin and BatchNorm of the copy, fed the card's input to it, is held
    to the card's output: the integer twins bit for bit, the first
    depthwise conv (the float path: no grid on the raw features) within (K +
    2) 2^-24 of sum |x w|, the BatchNorms within 1e-6 of their largest
    output. Then the copy runs end to end, its activation codes set to the
    card's at certified .5 ties (forced_act_codes), and its logits are held
    within 1e-5 of the card's largest."""
    from brevitas_tpu_torch.graph.convert_int import Int8InferenceConv
    from brevitas_tpu_torch.models.common import BatchNorm
    from brevitas_tpu_torch.nn.conv import conv_nd

    cpu_model = copy.deepcopy(model).to("cpu")
    seen, card_codes = [], []
    hooks = [mod.register_forward_hook(
        lambda mod, args, out, name=name: seen.append((name, args[0], out)))
        for name, mod in model.named_modules() if isinstance(mod, (Int8InferenceConv, BatchNorm))]
    with torch.no_grad(), recorded_act_codes(model, card_codes, act_layers(model)):
        logits = model(x.to(next(model.buffers()).device))
        torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    exact = float_path = bn_exact = 0
    worst = {"float_path": 0.0, "batch_norm": 0.0}
    with torch.no_grad():
        for name, inp, out in seen:
            mod = cpu_model.get_submodule(name)
            want, got = mod(_to_cpu(inp)), out.cpu()
            if isinstance(mod, BatchNorm):
                diff = float((got - want).abs().max())
                worst["batch_norm"] = max(worst["batch_norm"], diff / float(want.abs().max()))
                bn_exact += torch.equal(got, want)
                if diff > 1e-6 * float(want.abs().max()):
                    raise AssertionError(f"{what}: BatchNorm {name} is {diff:.3g} from its copy")
            elif getattr(inp, "scale", None) is None:
                # the float path: a float32 sum of K terms in another order
                v = _to_cpu(inp).double().abs()
                w = (mod.w_int.double() * mod.w_scale.double().reshape(-1, 1, 1)).abs()
                mass = conv_nd(v, w, mod.stride, mod._pads(v.shape[2:]), mod.dilation, mod.groups)
                k = mod.w_int[0].numel()
                ratio = float(((got - want).abs().double() / ((k + 2) * 2.0 ** -24 * mass)
                               .clamp_min(1e-300)).max())
                worst["float_path"] = max(worst["float_path"], ratio)
                float_path += 1
                if ratio > 1.0:
                    raise AssertionError(f"{what}: float-path twin {name} off its bound: {ratio}")
            else:
                if not torch.equal(got, want):
                    raise AssertionError(f"{what}: integer twin {name} disagrees with its CPU "
                                         f"copy: max {float((got - want).abs().max())}")
                exact += 1
        flips = []
        with forced_act_codes(cpu_model, card_codes, flips, act_layers(cpu_model)):
            cpu_logits = cpu_model(x.cpu())
    got = logits.cpu()
    diff = float((got - cpu_logits).abs().max())
    span = float(cpu_logits.abs().max())
    out = {"integer_twins_bit_for_bit": exact, "float_path_twins": float_path,
           "float_path_worst_share_of_bound": worst["float_path"],
           "batch_norms_bit_for_bit": f"{bn_exact} of {sum(isinstance(m, BatchNorm) for m in cpu_model.modules())}",
           "batch_norm_worst_rel": worst["batch_norm"], "cpu_tie_flips": sum(flips),
           "logits_max_diff": diff, "logits_bit_for_bit": torch.equal(got, cpu_logits)}
    print(f"[{what}] card vs CPU copy, layer by layer: {exact} integer twins bit for bit, "
          f"{float_path} float-path twin at {worst['float_path']:.3g} of its bound, "
          f"BatchNorms {out['batch_norms_bit_for_bit']} bit for bit (worst {worst['batch_norm']:.3g} "
          f"of the largest); end to end with {sum(flips)} codes set to the card's at certified "
          f"ties: logits max |diff| {diff:.3g} of span {span:.3g}, bit for bit "
          f"{out['logits_bit_for_bit']}")
    if not torch.isfinite(got).all() or diff > 1e-5 * span:
        raise AssertionError(f"{what}: logits disagree with the CPU copy")
    return out


def phase_quartznet_serving(dev) -> dict:
    """bench's quartznet_int8_serving leg on the card (see QN_*): one
    counted forward (94 int8_matmul launches, 185 fake_quant, nothing else
    counted), QN_SERVED_BATCHES served batches timed on the host clock with
    the features' copy in and the logits' copy out, the CPU-copy comparison
    and a profile of one batch."""
    from brevitas_tpu_torch import graph as G
    from brevitas_tpu_torch.graph.convert_int import Int8InferenceConv
    from brevitas_tpu_torch.models import quartznet_15x5

    what = "quartznet_serving"
    gc.collect()
    model = quartznet_15x5(generator=torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(0)

    def features():
        # bench's draw, (B, T, C), in the port's (B, C, T)
        return torch.from_numpy(np.ascontiguousarray(
            rng.random((QN_BATCH, QN_FRAMES, QN_FEATURES), dtype=np.float32).transpose(0, 2, 1)))

    with torch.no_grad():
        model(features().to(dev))  # train mode: the BatchNorm statistics move
    model.eval()
    G.convert_integer_inference(model)
    twins = [m for m in model.modules() if isinstance(m, Int8InferenceConv)]
    routes = sorted({str(t.acc_dtype) for t in twins if not t.pointwise})
    n_pw = sum(t.pointwise for t in twins)
    print(f"[{what}] {len(twins)} Int8InferenceConv twins: {n_pw} pointwise on int8_matmul, "
          f"{len(twins) - n_pw} on the exact route in {routes}")
    if len(twins) != QN_TWINS or n_pw != QN_INT8_PER_FORWARD or routes != ["torch.float32"]:
        raise AssertionError(f"{what}: twins {len(twins)} / {n_pw} pointwise / {routes}")
    batches = [features() for _ in range(QN_SERVED_BATCHES)]
    _reset_launch_counts()
    with torch.no_grad():
        logits = model(batches[0].to(dev))
    torch.cuda.synchronize()
    counts = _launch_counts()
    _record_path(what, counts)
    want = {k: 0 for k in counts}
    want.update(int8_matmul=QN_INT8_PER_FORWARD, fake_quant=QN_FQ_PER_FORWARD)
    print(f"[{what}] one forward: launches {counts}")
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")
    if tuple(logits.shape) != (QN_BATCH, 29, QN_FRAMES // 2) or not torch.isfinite(logits).all():
        raise AssertionError(f"{what}: logits of shape {tuple(logits.shape)} or not finite")
    with torch.no_grad():
        model(batches[0].to(dev)).cpu()
        t0 = time.perf_counter()
        for x in batches:
            model(x.to(dev)).cpu()
        ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    out = {"ms_per_batch": ms, "sequences_per_s": QN_BATCH / ms * 1e3,
           "launches_per_forward": counts}
    print(f"[{what}] {len(batches)} batches of {QN_BATCH} x {QN_FRAMES} frames: {ms:.3f} ms a "
          f"batch (host clock, copies in and out included), {out['sequences_per_s']:.1f} "
          f"sequences/s, on {CARD[0]}")
    out["cpu_copy"] = compare_quartznet_with_cpu_copy(model, batches[1], what)
    x = batches[2]
    out["profile"] = profile_steps(lambda: model(x.to(dev)).cpu(), what,
                                   f"batch of {QN_BATCH}", n=5)
    return out


# bench.py's mobilenetv1_4b_qat leg (bench.py:682-703, _scanned_train
# :226-262): quant_mobilenet_v1(bit_width=4), batch 32 at 224 px drawn as
# _scanned_train draws them (transposed to NCHW), softmax cross-entropy,
# Adam lr 1e-3, no weight clipping; one scanned epoch is 3 steps
MN_BATCH, MN_PX, MN_STEPS, MN_LR = 32, 224, 3, 1e-3
MN_CPU_LOSS_RTOL = 1e-5
# fake_quant launches a step: the 13 depthwise ReLUs, the last stage's 2
# pointwise ReLUs, the head's per-tensor weight and its IntBias, forward and
# backward (the per-channel weights and ReLUs take the plain chain)
MN_FQ = (17, 17)
# of its largest element: a gradient reached by the fake_quant kernel's
# scale sums against the plain chain's autograd sums on the card
MN_SCALE_GRAD_RTOL = 1e-3


def mobilenet_step(model, opt, x, y) -> torch.Tensor:
    """One step of bench's leg: softmax cross-entropy, Adam, no clipping."""
    opt.zero_grad(set_to_none=True)
    loss = torch.nn.functional.cross_entropy(model(x), y)
    loss.backward()
    opt.step()
    return loss.detach()


def mobilenet_replay(model, opt, plain, plain_opt, xs, ys) -> list:
    """The kernel path (``model``, a copy of its state before the timed
    steps) and the plain chain, one step each in turn: before each step the
    parameters that differ and by how much, in it the activation codes that
    differ (the first quantizer call that has one) and the two losses."""
    def codes_hook(store, name):
        def hook(mod, args, out):
            store.append((name, torch.round(out.value.detach() / out.scale.detach())
                          .to(torch.int16)))
        return hook

    rows = []
    for i in range(len(xs)):
        got_p, want_p = dict(model.named_parameters()), dict(plain.named_parameters())
        dev_p = {n: float((p.detach() - want_p[n].detach()).abs().max())
                 for n, p in got_p.items() if not torch.equal(p, want_p[n])}
        thresholds = {n: v for n, v in dev_p.items() if n.endswith("scaling.value")}
        codes = ([], [])
        layers = {m for m in act_layers(model) + act_layers(plain)}
        handles = [m.register_forward_hook(codes_hook(store, n))
                   for net, store in zip((model, plain), codes)
                   for n, m in net.named_modules() if m in layers]
        try:
            loss = mobilenet_step(model, opt, xs[i], ys[i])
            with plain_fake_quant():
                plain_loss = mobilenet_step(plain, plain_opt, xs[i], ys[i])
        finally:
            for h in handles:
                h.remove()
        flips = [(n, int((a != b).sum())) for (n, a), (_, b) in zip(*codes)]
        n_codes = sum(int(c.numel()) for _, c in codes[0])
        del codes
        first = next(((j, n, f) for j, (n, f) in enumerate(flips) if f), (None, None, None))
        rows.append({
            "step": i, "loss": float(loss), "plain_loss": float(plain_loss),
            "loss_dev": abs(float(loss) - float(plain_loss)),
            "params_differing": len(dev_p), "thresholds_differing": len(thresholds),
            "threshold_max_abs_dev": max(thresholds.values(), default=0.0),
            "other_params_differing": len(dev_p) - len(thresholds),
            "other_params_first": sorted(n for n in dev_p if n not in thresholds)[:4],
            "other_max_abs_dev": max((v for n, v in dev_p.items() if n not in thresholds),
                                     default=0.0),
            "code_flips": sum(f for _, f in flips), "codes": n_codes,
            "first_flip_call": first[0], "first_flip_layer": first[1],
            "first_flip_count": first[2]})
    return rows


def phase_mobilenet_qat(dev, bf16: bool) -> dict:
    """bench's mobilenetv1_4b_qat step at full width, nothing cut: a warm-up
    and MN_STEPS timed steps in bf16 operands (bench's default) or float32.
    A copy on the card runs the plain chain in every quantizer: the
    warm-up's loss the same bits, every gradient too but those the kernel's
    scale sums reach (MN_SCALE_GRAD_RTOL), each later step's loss difference
    reported, and a replay of the timed steps beside the plain chain names
    where the two part (mobilenet_replay). A CPU copy's first loss within MN_CPU_LOSS_RTOL, its
    activation codes set to the card's at certified .5 ties."""
    from brevitas_tpu_torch.models import quant_mobilenet_v1
    from brevitas_tpu_torch.utils import set_compute_dtype

    what = f"mobilenet_qat_{'bf16' if bf16 else 'float32'}"
    gc.collect()
    torch.cuda.empty_cache()
    model = quant_mobilenet_v1(bit_width=4, generator=torch.Generator().manual_seed(0),
                               device=dev)
    if bf16:
        set_compute_dtype(model, torch.bfloat16)
    plain = copy.deepcopy(model)
    cpu_model = copy.deepcopy(model).to("cpu")
    rng = np.random.default_rng(0)
    xs_np = np.ascontiguousarray(rng.random((MN_STEPS, MN_BATCH, MN_PX, MN_PX, 3),
                                            dtype=np.float32).transpose(0, 1, 4, 2, 3))
    ys_np = rng.integers(0, 10, (MN_STEPS, MN_BATCH)).astype(np.int64)
    xs, ys = torch.from_numpy(xs_np).to(dev), torch.from_numpy(ys_np).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=MN_LR)
    plain_opt = torch.optim.Adam(plain.parameters(), lr=MN_LR)

    card_codes, fq_calls = [], []
    _reset_launch_counts()
    with recorded_act_codes(model, card_codes, act_layers(model)), \
            recorded_fake_quant_calls(fq_calls):
        loss0 = mobilenet_step(model, opt, xs[0], ys[0])
    torch.cuda.synchronize()
    warm_counts = _launch_counts()
    # the shapes fake_quant_kernels and fake_quant_spread time as this step's
    want_calls = sorted((sh, bwd == fwd) for sh, fwd, bwd in MOBILENET_FQ_STEP_SHAPES
                        for _ in range(fwd))
    if sorted(fq_calls) != want_calls:
        raise AssertionError(f"{what}: fake_quant calls (shape, backward) {sorted(fq_calls)}, "
                             f"MOBILENET_FQ_STEP_SHAPES gives {want_calls}")
    with plain_fake_quant():
        plain0 = mobilenet_step(plain, plain_opt, xs[0], ys[0])
    torch.cuda.synchronize()
    if not torch.equal(loss0, plain0):
        raise AssertionError(f"{what}: first-step loss {float(loss0)} differs from the plain "
                             f"chain's {float(plain0)}")
    plain_params = dict(plain.named_parameters())
    # the kernel's scale gradient is its own sum (within 1e-5 of sum |term|
    # of the float64 sum: fake_quant_kernels), so the learned thresholds of
    # the per-tensor quantizers, and the head's weight (its per-tensor scale
    # comes from its largest element), may differ from the plain chain's
    # autograd sums in their last bits; every other gradient the same bits
    from brevitas_tpu_torch.quant.quantizers import ActQuantizer

    summed = {f"{n}.scaling.value" for n, m in model.named_modules()
              if isinstance(m, ActQuantizer) and m.quant_type.value == "int"
              and not m.per_channel} | {"output.weight"}
    differ, sum_dev = [], 0.0
    for n, p in model.named_parameters():
        want = plain_params[n].grad
        if torch.equal(p.grad, want):
            continue
        dev_n = float((p.grad - want).abs().max() / want.abs().max())
        if n not in summed or dev_n > MN_SCALE_GRAD_RTOL:
            differ.append((n, dev_n))
        sum_dev = max(sum_dev, dev_n)
    if differ:
        raise AssertionError(f"{what}: first-step gradients differ from the plain chain's: "
                             f"{differ}")
    flips = []
    with torch.no_grad(), forced_act_codes(cpu_model, card_codes, flips, act_layers(cpu_model)):
        cpu_loss = float(torch.nn.functional.cross_entropy(
            cpu_model(torch.from_numpy(xs_np[0])), torch.from_numpy(ys_np[0])))
    del card_codes, cpu_model
    cpu_dev = abs(float(loss0) - cpu_loss) / abs(cpu_loss)
    print(f"[{what}] warm-up step: loss {float(loss0)} the same bits as the plain chain's; "
          f"of {len(plain_params)} gradients all but the {len(summed)} reached by the "
          f"kernel's scale sums the same bits, those within {sum_dev:.3g} of their largest; "
          f"CPU copy's loss {cpu_loss} (relative {cpu_dev:.3g}) with {sum(flips)} codes set "
          f"to the card's at certified ties; launches {warm_counts}")
    if cpu_dev > MN_CPU_LOSS_RTOL:
        raise AssertionError(f"{what}: the card's first loss is {cpu_dev:.3g} from a CPU copy's")
    fq_want = {"fake_quant": MN_FQ[0], "fake_quant_backward": MN_FQ[1]}
    if any(warm_counts[k] != fq_want.get(k, 0) for k in warm_counts):
        raise AssertionError(f"{what}: launches {warm_counts}, expected {fq_want}")

    # the kernel path's state before the timed steps, replayed beside the
    # plain chain after them
    replay = copy.deepcopy(model)
    replay_opt = torch.optim.Adam(replay.parameters(), lr=MN_LR)
    replay_opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    torch.cuda.synchronize()
    _reset_launch_counts()
    t0 = time.perf_counter()
    losses = [mobilenet_step(model, opt, xs[i], ys[i]) for i in range(MN_STEPS)]
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    counts = _launch_counts()
    _record_path(what, {k: v + warm_counts[k] for k, v in counts.items()})
    want = {k: MN_STEPS * fq_want.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts} over {MN_STEPS} steps, "
                             f"expected {want}")
    replayed = mobilenet_replay(replay, replay_opt, plain, plain_opt, xs, ys)
    del plain, plain_opt, replay, replay_opt
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: losses {losses}")
    step_dev = [abs(a - r["plain_loss"]) for a, r in zip(losses, replayed)]
    replay_same = [a == r["loss"] for a, r in zip(losses, replayed)]
    for r in replayed:
        print(f"[{what}] replay of timed step {r['step']} beside the plain chain: before it "
              f"{r['thresholds_differing']} thresholds differ (max |diff| "
              f"{r['threshold_max_abs_dev']:.3g}) and {r['other_params_differing']} other "
              f"parameters (max |diff| {r['other_max_abs_dev']:.3g}: "
              f"{r['other_params_first']}); in it {r['code_flips']} of {r['codes']} "
              f"activation codes differ, the first at call {r['first_flip_call']} "
              f"({r['first_flip_layer']}, {r['first_flip_count']}); loss |diff| "
              f"{r['loss_dev']:.3g}")
    ms = total_ms / MN_STEPS
    out = {"compute_dtype": "bf16" if bf16 else "float32", "ms_per_step": ms,
           "images_per_s": MN_BATCH / ms * 1e3, "losses": losses, "first_loss": float(loss0),
           "cpu_first_loss_rel_dev": cpu_dev, "cpu_tie_flips": sum(flips),
           "scale_grad_max_rel_dev": sum_dev, "loss_dev_per_step": step_dev,
           "replay_same_losses": replay_same, "replay": replayed,
           "fake_quant_per_step": counts["fake_quant"] / MN_STEPS,
           "fake_quant_backward_per_step": counts["fake_quant_backward"] / MN_STEPS}
    print(f"[{what}] {MN_STEPS} steps: {ms:.3f} ms per step (host clock over the epoch, "
          f"synchronized at its end), {out['images_per_s']:.1f} images/s, "
          f"{out['compute_dtype']} operands, on {CARD[0]}; fake_quant launches per step "
          f"{out['fake_quant_per_step']:g} forward, {out['fake_quant_backward_per_step']:g} "
          f"backward; kernel path vs plain chain: loss |diff| per step {step_dev}")

    def one_step():
        mobilenet_step(model, opt, xs[0], ys[0])
        torch.cuda.synchronize()

    out["profile"] = profile_steps(one_step, what, "training step", n=3, grad=True)
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[{what}] device busy {out['profile']['busy_ms']:.4f} ms a step, idle share "
          f"{out['profile']['idle_share']:.3f}, {out['compute_dtype']} operands, peak memory "
          f"{out['peak_memory_gb']:.2f} GiB, on {CARD[0]}")
    return out



# ---------------------------------------------------------------------------
# CNN post-training quantization (slice 9c): examples.ptq_calibrate and the
# flexml flow on a full-width float ResNet-18
# ---------------------------------------------------------------------------

# the CLI's two runs at its defaults (5 float epochs at batch 128, 4
# calibration batches, 2 bias-correction batches, 1,000 AdaRound steps)
PTQ_RUNS = {"mlp_pc_adaround": ["--model", "mlp", "--per-channel", "--learned-round",
                                "--convert-int"],
            "convnet_fp_gptq": ["--model", "convnet", "--fixed-point", "--gptq",
                                "--convert-int"]}
# the JAX CLI tests' bounds (tests/test_end_to_end.py): float accuracy above,
# fake-quant and served accuracy within this much of float, and the conv
# net's preprocessed accuracy within 0.02 of float
PTQ_BOUNDS = {"mlp_pc_adaround": (0.8, 0.05, 0.05), "convnet_fp_gptq": (0.75, 0.06, 0.05)}
PTQ_PREPROCESSED_TOL = 0.02
# the serving twins each run leaves, and int8_matmul launches over main: the
# served scoring of the 360 test digits in 2 batches, one a linear
PTQ_TWINS = {"mlp_pc_adaround": {"Int8InferenceLinear": 3},
             "convnet_fp_gptq": {"Int8InferenceLinear": 1, "Int8InferenceConv": 2}}
PTQ_TEST_BATCHES = 2
# float ResNet-18 at full width (11.2 M parameters), CIFAR stem, 10 classes,
# on 32 x 32 x 3 images drawn as bench's load_synthetic("train", "cnv") draws
# them; BatchNorm statistics from 10 train-mode forwards at batch 256
RESNET_BATCH = 256
RESNET_BN_FORWARDS = 10
RESNET_CALIB = 4
RESNET_BIAS = 2
RESNET_CPU_IMAGES = 16   # rows of the served batch held against a CPU copy
RESNET_PAIRS = 20
# the regions tests/test_torch_port_ptq.py holds to the JAX package's at width
# 0.125: the same paths at every width
RESNET_REGIONS = sorted(
    [(["blocks.0.conv2.conv", "blocks.1.conv2.conv", "stem.conv"],
      ["blocks.0.conv1.conv", "blocks.1.conv1.conv", "blocks.2.conv1.conv",
       "blocks.2.downsample.conv"]),
     (["blocks.2.conv2.conv", "blocks.2.downsample.conv", "blocks.3.conv2.conv"],
      ["blocks.3.conv1.conv", "blocks.4.conv1.conv", "blocks.4.downsample.conv"]),
     (["blocks.4.conv2.conv", "blocks.4.downsample.conv", "blocks.5.conv2.conv"],
      ["blocks.5.conv1.conv", "blocks.6.conv1.conv", "blocks.6.downsample.conv"]),
     (["blocks.6.conv2.conv", "blocks.6.downsample.conv", "blocks.7.conv2.conv"],
      ["blocks.7.conv1.conv", "output"])]
    + [([f"blocks.{i}.conv1.conv"], [f"blocks.{i}.conv2.conv"]) for i in range(8)])
# the JAX model zoo test's bound on fake-quant against float
# (tests/test_model_zoo.py): err < 0.35 * span + 0.1
RESNET_FQ_BOUND = (0.35, 0.1)
# served against fake-quant: the twins compute the fake-quant function up to
# float32 rounding and .5 ties of the activation codes; a CPU run at width
# 0.125 measured 3 % of the span
RESNET_SERVED_VS_FQ = 0.1
# a served forward: the head and the 3 strided 1 x 1 shortcuts on
# int8_matmul, the other 17 convs on the exact route; a fake-quant forward:
# input, weight and 32-bit bias quantizers of the 21 layers on fake_quant
RESNET_SERVED_INT8 = 4
RESNET_FQ_FORWARD = 3 * 21


@contextlib.contextmanager
def checked_kernel_calls(counts: dict):
    """Every call of the quantizers' fake_quant and of the serving twins'
    int8_matmul held, as it returns, against its plain version on the same
    inputs (bit for bit). Each 32-bit bias call (clamp bounds -2^31 and
    2^31) is also held against core/quant.py's chain. The checks launch no
    kernel; ``counts`` gets the calls checked."""
    from brevitas_tpu_torch.core import quant as Qf
    from brevitas_tpu_torch.graph import convert_int as CI
    from brevitas_tpu_torch.kernels import fake_quant_reference, int8_matmul_reference
    from brevitas_tpu_torch.quant import quantizers

    real_fq, real_mm = quantizers.fake_quant, CI.int8_matmul
    counts.update(fake_quant=0, int8_matmul=0, bias32=0)

    def fq(x, scale, zero_point, lo, hi, *args, **kw):
        y = real_fq(x, scale, zero_point, lo, hi, *args, **kw)
        with torch.no_grad():
            if not torch.equal(y, fake_quant_reference(x, scale, zero_point, lo, hi)):
                raise AssertionError(f"fake_quant at {tuple(x.shape)} on [{lo}, {hi}] differs "
                                     "from its plain version")
            if lo == -2.0 ** 31:
                chain = Qf.int_quant(x, scale, zero_point, 32.0, signed=True,
                                     narrow_range=False)
                if not torch.equal(y, chain):
                    raise AssertionError("the 32-bit bias on fake_quant differs from the chain")
                counts["bias32"] += 1
        counts["fake_quant"] += 1
        return y

    def mm(*args, **kw):
        y = real_mm(*args, **kw)
        if not torch.equal(y, int8_matmul_reference(*args, **kw)):
            raise AssertionError(f"int8_matmul at {tuple(args[0].shape)} x "
                                 f"{tuple(args[1].shape)} differs from its plain version")
        counts["int8_matmul"] += 1
        return y

    quantizers.fake_quant, CI.int8_matmul = fq, mm
    try:
        yield
    finally:
        quantizers.fake_quant, CI.int8_matmul = real_fq, real_mm


def compare_twins_with_cpu_copy(model, x: torch.Tensor, what: str, rows: int) -> dict:
    """Serve ``x`` on the card; hold each serving twin (Int8InferenceLinear,
    Int8InferenceConv) of a CPU copy, fed the first ``rows`` rows of the
    card's input to it, against the card's output bit for bit, and the
    copy's logits of those rows end to end, bit for bit. Returns the card's
    logits."""
    from brevitas_tpu_torch.graph.convert_int import Int8InferenceConv, Int8InferenceLinear

    twins = (Int8InferenceLinear, Int8InferenceConv)
    cpu_model = copy.deepcopy(model).to("cpu")
    seen = []
    hooks = [mod.register_forward_hook(
        lambda mod, args, out, name=name: seen.append(
            (name, _to_cpu(args[0][:rows]), out[:rows].cpu())))
        for name, mod in model.named_modules() if isinstance(mod, twins)]
    try:
        with torch.no_grad():
            logits = model(x)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    kinds = {}
    with torch.no_grad():
        for name, inp, got in seen:
            twin = cpu_model.get_submodule(name)
            want = twin(inp)
            kinds[type(twin).__name__] = kinds.get(type(twin).__name__, 0) + 1
            if not torch.equal(got, want):
                raise AssertionError(f"{what}: twin {name} disagrees with its CPU copy: max "
                                     f"{float((got - want).abs().max())}")
        cpu_logits = cpu_model(x[:rows].cpu())
    got = logits[:rows].cpu()
    same = torch.equal(got, cpu_logits)
    print(f"[{what}] {len(seen)} twins {kinds} of a CPU copy fed the card's inputs ({rows} "
          f"rows): bit for bit; logits of those rows end to end bit for bit: {same} (max |diff| "
          f"{float((got - cpu_logits).abs().max()):.3g})")
    if not torch.isfinite(logits).all() or not same:
        raise AssertionError(f"{what}: logits disagree with the CPU copy")
    return logits


def phase_ptq_calibrate(dev, run: str) -> dict:
    """examples.ptq_calibrate.main on the card: run (a) ``--model mlp
    --per-channel --learned-round --convert-int`` (1,000 AdaRound steps a
    layer) or (b) ``--model convnet --fixed-point --gptq --convert-int``,
    on the repository's digits. Every fake_quant and int8_matmul call over
    main held against its plain version (checked_kernel_calls; the stage
    times include those checks); the launches over main and over one served
    forward of the test set; the serving twins; the converted model against
    a CPU copy (compare_twins_with_cpu_copy, every row); the JAX tests'
    accuracy bounds; each stage's host ms; AdaRound's per-layer output MSE,
    nearest against learned."""
    from brevitas_tpu_torch.examples import ptq_calibrate

    what = f"ptq_calibrate_{run}"
    keep, checked = {}, {}
    _reset_launch_counts()
    t0 = time.perf_counter()
    with checked_kernel_calls(checked):
        result = ptq_calibrate.main(PTQ_RUNS[run] + ["--device", str(dev)], keep=keep)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = _launch_counts()
    _record_path(what, counts)
    print(f"[{what}] main {main_s:.1f} s ({CARD[0]}): launches {counts}; calls held bit for "
          f"bit against their plain versions: {checked}")
    if counts["int8_matmul"] != sum(PTQ_TWINS[run].get("Int8InferenceLinear", 0)
                                    for _ in range(PTQ_TEST_BATCHES)):
        raise AssertionError(f"{what}: int8_matmul launched {counts['int8_matmul']} times")
    if counts["fake_quant"] == 0 or counts["fake_quant"] != checked["fake_quant"]:
        raise AssertionError(f"{what}: fake_quant launches {counts['fake_quant']} against "
                             f"{checked['fake_quant']} calls checked")
    others = {k: v for k, v in counts.items() if k not in ("int8_matmul", "fake_quant") and v}
    if others:
        raise AssertionError(f"{what}: unexpected launches {others}")
    model, x_test, y_test = keep["model"], keep["x_test"], keep["y_test"]
    twins = {}
    for mod in model.modules():
        if "Inference" in type(mod).__name__:
            twins[type(mod).__name__] = twins.get(type(mod).__name__, 0) + 1
    if twins != PTQ_TWINS[run]:
        raise AssertionError(f"{what}: serving twins {twins}, expected {PTQ_TWINS[run]}")
    x = torch.from_numpy(x_test).to(dev)
    _reset_launch_counts()
    with torch.no_grad(), checked_kernel_calls({}):
        model(x)
    torch.cuda.synchronize()
    per_forward = _launch_counts()
    print(f"[{what}] one served forward of the {len(x_test)} test digits: launches "
          f"{per_forward}")
    if per_forward["int8_matmul"] != PTQ_TWINS[run].get("Int8InferenceLinear", 0):
        raise AssertionError(f"{what}: a served forward launched {per_forward}")
    compare_twins_with_cpu_copy(model, x, what, rows=len(x_test))

    floor, ptq_tol, int_tol = PTQ_BOUNDS[run]
    fa, pa, qa, ia = (result[k] for k in ("float_acc", "preprocessed_acc", "ptq_acc", "int_acc"))
    print(f"[{what}] accuracy: float {fa}, preprocessed {pa}, fake-quant {qa}, served {ia} "
          f"(bounds: float > {floor}, fake-quant > float - {ptq_tol}, served > float - "
          f"{int_tol})")
    if not (fa > floor and qa > fa - ptq_tol and ia > fa - int_tol):
        raise AssertionError(f"{what}: accuracy out of the JAX tests' bounds")
    if run.startswith("convnet") and abs(pa - fa) > PTQ_PREPROCESSED_TOL:
        raise AssertionError(f"{what}: preprocessing moved the accuracy by {pa - fa}")
    mse = keep["learned_round"]
    if mse:
        print(f"[{what}] AdaRound output MSE a layer (nearest, learned): "
              + ", ".join(f"{p} ({a:.4g}, {b:.4g})" for p, (a, b) in mse.items()))
    print(f"[{what}] stages (host ms, {CARD[0]}): "
          + ", ".join(f"{k} {v:.1f}" for k, v in keep["stage_ms"].items()))

    def forward():
        model(x)
        torch.cuda.synchronize()

    out = {"card": CARD[0], "result": result, "launches_over_main": counts,
           "launches_per_forward": per_forward, "calls_checked": checked,
           "stage_ms": keep["stage_ms"], "main_s": main_s, "twins": twins,
           "adaround_mse": mse}
    out["profile"] = profile_steps(forward, what, f"served forward of {len(x_test)}")
    return out


def phase_flexml_resnet18(dev, keep: dict = None) -> dict:
    """The flexml flow on float_resnet(18, width_mult=1.0) (CIFAR stem, 10
    classes, 11.2 M parameters; random weights from seed 0), at bench's
    CNV inputs: BatchNorm statistics from RESNET_BN_FORWARDS train-mode
    forwards, then preprocess_flexml from one image (20 pairs, the regions
    of RESNET_REGIONS), quantize_flexml, calibration (RESNET_CALIB batches),
    bias correction (RESNET_BIAS), the fake-quant forward against float (the
    JAX zoo test's bound), convert_integer_inference and a served forward at
    batch 256: its launches, every fake_quant and int8_matmul call against
    its plain version, the twins against a CPU copy on RESNET_CPU_IMAGES
    rows, served against fake-quant, the exact route's float32 / float64
    split, host ms a stage and a profile of one served forward. ``keep``, a
    dict, receives a copy of the fake-quant model (before the conversion)
    and its input batch."""
    from brevitas_tpu_torch import graph as G
    from brevitas_tpu_torch.examples.bnn_pynq import load_synthetic
    from brevitas_tpu_torch.graph.convert_int import Int8InferenceConv
    from brevitas_tpu_torch.models import float_resnet

    what = "flexml_resnet18"
    stage = {}

    def timed_stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stage[name] = (time.perf_counter() - t0) * 1e3
        return out

    x_all, _ = load_synthetic("train", "cnv")
    x_all = torch.from_numpy(x_all).to(dev)
    batches = [x_all[i * RESNET_BATCH:(i + 1) * RESNET_BATCH] for i in range(8)]
    model = float_resnet(18, num_classes=10, width_mult=1.0,
                         generator=torch.Generator().manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in model.parameters())

    def bn_stats():
        model.train()
        with torch.no_grad():
            for i in range(RESNET_BN_FORWARDS):
                model(batches[i % len(batches)])
        model.eval()

    timed_stage("bn_statistics", bn_stats)
    x = batches[-1]
    with torch.no_grad():
        y_float = timed_stage("float_forward", lambda: model(x))
    pairs = G.find_bn_pairs(model, x[:1])
    timed_stage("preprocess", lambda: G.preprocess_flexml(model, x[:1]))
    regions = sorted(G.extract_regions(model, x[:1]))
    print(f"[{what}] {n_params} parameters; {len(pairs)} BatchNorm pairs, {len(regions)} "
          f"equalization regions ({CARD[0]})")
    if len(pairs) != RESNET_PAIRS or regions != RESNET_REGIONS:
        raise AssertionError(f"{what}: pairs {pairs} or regions {regions} are not the JAX "
                             "package's")
    with torch.no_grad():
        gap = float((model(x) - y_float).abs().max())
    print(f"[{what}] preprocessed against float: max |diff| {gap:.3g}")
    timed_stage("quantize", lambda: G.quantize_flexml(model, collect_stats_steps=RESNET_CALIB))

    def calibrate():
        with torch.no_grad(), G.calibration_mode(model):
            for b in batches[:RESNET_CALIB]:
                model(b)
        model.eval()

    def bias_correct():
        with torch.no_grad(), G.bias_correction_mode(model):
            for b in batches[:RESNET_BIAS]:
                model(b)

    timed_stage("calibrate", calibrate)
    timed_stage("bias_correction", bias_correct)
    checked = {}
    _reset_launch_counts()
    with torch.no_grad(), checked_kernel_calls(checked):
        y_q = timed_stage("fake_quant_forward", lambda: model(x))
    fq_counts = _launch_counts()
    _record_path(f"{what}_fake_quant", fq_counts)
    err, span = float((y_q - y_float).abs().max()), float(y_float.abs().max())
    bound = RESNET_FQ_BOUND[0] * span + RESNET_FQ_BOUND[1]
    print(f"[{what}] fake-quant forward: launches {fq_counts} (checked {checked}); against "
          f"float max |diff| {err:.4g} of span {span:.4g} (bound {bound:.4g})")
    if not torch.isfinite(y_q).all() or err >= bound:
        raise AssertionError(f"{what}: fake-quant output out of the JAX zoo test's bound")
    if fq_counts["fake_quant"] != RESNET_FQ_FORWARD or checked["bias32"] != 21:
        raise AssertionError(f"{what}: expected {RESNET_FQ_FORWARD} fake_quant launches, 21 of "
                             "them 32-bit biases")
    if keep is not None:
        keep.update(fake_quant_model=copy.deepcopy(model), x=x)
    timed_stage("convert_int", lambda: G.convert_integer_inference(model))
    convs = [m for m in model.modules() if isinstance(m, Int8InferenceConv)]
    split = {"int8_matmul": sum(c.pointwise for c in convs),
             "float32": sum(not c.pointwise and c.acc_dtype == torch.float32 for c in convs),
             "float64": sum(not c.pointwise and c.acc_dtype == torch.float64 for c in convs)}
    print(f"[{what}] {len(convs)} Int8InferenceConv: {split} (float64 where K * 128 * 127 "
          "passes 2^24: 3 x 3 convs of 128 or more input channels)")
    checked = {}
    _reset_launch_counts()
    with torch.no_grad(), checked_kernel_calls(checked):
        y_int = timed_stage("served_forward", lambda: model(x))
    counts = _launch_counts()
    _record_path(what, counts)
    print(f"[{what}] served forward at batch {RESNET_BATCH}: launches {counts} (checked "
          f"{checked})")
    compare_twins_with_cpu_copy(model, x, what, RESNET_CPU_IMAGES)
    want = dict.fromkeys(counts, 0)
    want["int8_matmul"] = RESNET_SERVED_INT8
    if counts != want:
        raise AssertionError(f"{what}: expected launches {want}")
    served_gap = float((y_int - y_q).abs().max())
    agree = float((y_int.argmax(1) == y_q.argmax(1)).float().mean())
    print(f"[{what}] served against fake-quant: max |diff| {served_gap:.4g} of span {span:.4g},"
          f" argmax agreement {agree}")
    if served_gap > RESNET_SERVED_VS_FQ * span:
        raise AssertionError(f"{what}: served output far from fake-quant")
    print(f"[{what}] stages (host ms, {CARD[0]}): "
          + ", ".join(f"{k} {v:.1f}" for k, v in stage.items()))

    def forward():
        with torch.no_grad():
            model(x)
        torch.cuda.synchronize()

    out = {"card": CARD[0], "parameters": n_params, "pairs": len(pairs),
           "regions": len(regions), "fq_vs_float": err, "span": span,
           "served_vs_fq": served_gap, "argmax_agreement": agree, "exact_route": split,
           "launches_fake_quant_forward": fq_counts, "launches_served_forward": counts,
           "stage_ms": stage}
    out["profile"] = profile_steps(forward, what, f"served forward of {RESNET_BATCH}")
    return out


# ---------------------------------------------------------------------------
# Export (slice 10): ptq_calibrate --export and the exporters on LFC, CNV and
# the flexml ResNet-18
# ---------------------------------------------------------------------------

# the CLI's defaults with --export (the test digits are the 360 scored)
EXPORT_PTQ_RUNS = {"mlp_qcdq": ["--model", "mlp", "--export", "qcdq"],
                   "mlp_qop": ["--model", "mlp", "--export", "qop"],
                   "convnet_qonnx": ["--model", "convnet", "--fixed-point", "--export", "qonnx"]}
# the JAX export tests' tolerances (tests/test_export.py): linear nets and
# conv nets, (rtol, atol); QOp: one step of the last layer's accumulator grid
EXPORT_TOL = {"linear": (1e-4, 1e-4), "conv": (1e-3, 1e-4)}
EXPORT_LFC_STEPS = 3     # QAT steps before LFC's export, at lfc_qat's batch
EXPORT_LFC_BATCH = 64    # rows interpreted
EXPORT_CNV_BATCH = 8
EXPORT_RESNET_BATCH = 2
EXPORT_TORCH_TOL = 1e-5  # the TorchScript twin against the model (JAX tests/test_torch_export.py)
# an activation code of the graph may differ from the card's only at a .5
# tie: by one, the two pre-quant values on either side of the half step and
# within this share of the largest of them
EXPORT_TIE_SHARE = 1e-5
RESNET_CONVS = 20        # convs of the derived walk, 3 of them the strided 1 x 1 shortcuts


def act_chains(blob: bytes) -> dict:
    """The graph's activation quantizers: the output name of the node ending
    each one -> (its pre-quant input, scale and zero-point names, "value"
    for a dequantized output or "codes" for QOp's integer input)."""
    from brevitas_tpu_torch.export.onnx_proto import parse_model

    g = parse_model(blob)
    consumers = {}
    for n in g.nodes:
        for name in n.inputs:
            consumers.setdefault(name, []).append(n)

    def only(n, op):
        nxt = consumers.get(n.outputs[0], [])
        return nxt[0] if len(nxt) == 1 and nxt[0].op_type == op else None

    chains = {}
    for n in g.nodes:
        ins = n.inputs
        if n.op_type == "QuantizeLinear" and ins[1].startswith(("act_scale", "x_scale")):
            end, kind = n, "codes"
            end = only(end, "Clip") or end
            deq = only(end, "DequantizeLinear")
            if deq is not None:
                end, kind = deq, "value"
            chains[end.outputs[0]] = (ins[0], ins[1], ins[2], kind)
        elif n.op_type == "Quant" and ins[1].startswith("act_scale"):
            chains[n.outputs[0]] = (ins[0], ins[1], ins[2], "value")
        elif n.op_type == "MultiThreshold":
            end = only(n, "Add") or n
            mul = only(end, "Mul")
            if mul is None or not mul.inputs[1].startswith("act_scale"):
                raise AssertionError("a MultiThreshold without its scale")
            chains[mul.outputs[0]] = (ins[0], mul.inputs[1], None, "value")
    return chains


@contextlib.contextmanager
def recorded_act_calls(model, store: list):
    """(input, output value) of each activation quantizer call, in order."""
    from brevitas_tpu_torch.quant.config import QuantType
    from brevitas_tpu_torch.quant.quantizers import ActQuantizer

    def hook(mod, args, out):
        store.append((args[0].detach().cpu().numpy(), out.value.detach().cpu().numpy()))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, ActQuantizer) and m.quant_type != QuantType.NONE]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def interpret_against_model(blob: bytes, model, x: torch.Tensor, tol, what: str) -> dict:
    """Run the exported graph in the port's interpreter on ``x`` (copied to
    the host) beside the card's forward. Each activation quantizer of the
    graph is held to the card's call of it: a code may differ only at a
    certified .5 tie (a flip: counted, FINN's MultiThreshold rounds such a
    tie up where the model rounds half to even), and the graph goes on from
    the card's codes. The graph's output must then be the card's within
    ``tol`` (rtol, atol). Also the graph run free (no codes replaced)."""
    from brevitas_tpu_torch.export import run_onnx

    calls = []
    with torch.no_grad(), recorded_act_calls(model, calls):
        y = model(x)
    torch.cuda.synchronize()
    y = (y.value if hasattr(y, "value") else y).cpu().numpy()
    x_np = x.cpu().numpy()
    chains = act_chains(blob)
    state = {"i": 0, "flips": 0}

    def on_output(node, value, env):
        chain = chains.get(node.outputs[0])
        if chain is None:
            return value
        pre, s_name, z_name, kind = chain
        i = state["i"]
        state["i"] += 1
        if i >= len(calls):
            raise AssertionError(f"{what}: the graph quantizes more activations than the "
                                 f"model ({len(calls)})")
        want_x, want_y = calls[i]
        s = env[s_name].astype(np.float64)
        zp = 0.0 if z_name is None else env[z_name].astype(np.float64)
        centered = (value.astype(np.float64) - zp if kind == "codes"
                    else np.round(value.astype(np.float64) / s))
        c_want = np.round(want_y.astype(np.float64) / s)
        if centered.shape != c_want.shape:
            raise AssertionError(f"{what}: activation {i}: graph {centered.shape}, model "
                                 f"{c_want.shape}")
        differ = centered != c_want
        if differ.any():
            s_b = np.broadcast_to(s, differ.shape)[differ]
            half = (centered[differ] + c_want[differ]) / 2
            got_x = np.broadcast_to(env[pre], differ.shape)[differ]
            mine_x = want_x[differ]
            ok = ((np.abs(centered[differ] - c_want[differ]) == 1)
                  & ((got_x / s_b - half) * (mine_x / s_b - half) <= 0)
                  & (np.abs(got_x - mine_x) <= EXPORT_TIE_SHARE * np.abs(want_x).max()))
            if not ok.all():
                raise AssertionError(f"{what}: activation {i}: {int((~ok).sum())} codes differ "
                                     "from the card's away from a .5 tie")
            state["flips"] += int(differ.sum())
        if kind == "codes":
            return (c_want + zp).astype(value.dtype)
        return want_y.astype(np.float32)

    t0 = time.perf_counter()
    (got,) = run_onnx(blob, {"input": x_np}, on_output=on_output)
    interp_s = time.perf_counter() - t0
    if state["i"] != len(calls):
        raise AssertionError(f"{what}: the graph quantizes {state['i']} activations, the "
                             f"model {len(calls)}")
    rtol, atol = tol
    err = float(np.abs(got - y).max())
    if got.shape != y.shape or not np.allclose(got, y, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: the graph's output is {err:.3g} from the card's "
                             f"(rtol {rtol}, atol {atol})")
    (free,) = run_onnx(blob, {"input": x_np})
    return {"flips": state["flips"], "act_quantizers": len(calls), "max_abs_err": err,
            "free_max_abs_err": float(np.abs(free - y).max()), "free": free, "y": y,
            "interp_s": interp_s}


def timed_export(fn, model, x, what):
    """One export on the card: (bytes, ms), the bytes validated."""
    from brevitas_tpu_torch.export import validate_onnx

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = fn(model, x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    validate_onnx(blob)
    return blob, ms


def _export_row(rows: dict, what: str, blob: bytes, ms: float, check: dict, style: str):
    rows[what] = {"ms": ms, "bytes": len(blob), "flips": check["flips"],
                  "act_quantizers": check["act_quantizers"],
                  "max_abs_err": check["max_abs_err"],
                  "free_max_abs_err": check["free_max_abs_err"],
                  "interp_s": check["interp_s"]}
    kind = "FINN half-up flips" if style == "finn" else "tie flips"
    print(f"[export] {what}: {ms:.1f} ms on {CARD[0]}, {len(blob)} bytes, validated; "
          f"interpreted ({check['interp_s']:.2f} s on the host) against the card: "
          f"{check['act_quantizers']} activation quantizers, {kind} {check['flips']}, output "
          f"max |diff| {check['max_abs_err']:.3g} (run free: {check['free_max_abs_err']:.3g})")


def phase_export(dev, resnet: dict) -> dict:
    """The exporters on the card (slice 10), every fake_quant call held
    against its plain version as it returns (checked_kernel_calls), the
    launches counted:
    (a) ptq_calibrate.main at the CLI's defaults with --export (EXPORT_PTQ_RUNS):
        the file validates; the interpreter, held to the card's
        activations (interpret_against_model), gives the card's output on
        the 360 test digits within the JAX export tests' tolerance; the
        graph run free scores the run's ptq_acc;
    (b) LFC INT4 at bench's width (784-1024-1024-1024-10) after
        EXPORT_LFC_STEPS QAT steps at lfc_qat's batch: QONNX, FINN and QCDQ
        interpreted on EXPORT_LFC_BATCH rows; export_native and load_native
        (the integer weights the model's codes); export_torch_qcdq traced on
        the card, within EXPORT_TORCH_TOL of the model;
    (c) CNV_4W4A at bench's width (BatchNorm statistics from one train-mode
        forward at batch 256): QCDQ and FINN on EXPORT_CNV_BATCH images;
    (d) the flexml_resnet18 phase's fake-quant model: QCDQ through the
        derived residual walk (RESNET_CONVS convs) on EXPORT_RESNET_BATCH
        images.
    Each export's host ms, bytes, and flips at .5 ties (FINN's half-up
    rounding among them)."""
    import tempfile

    from brevitas_tpu_torch import export as E
    from brevitas_tpu_torch.examples import bnn_pynq, ptq_calibrate
    from brevitas_tpu_torch.export.qcdq import export_items
    from brevitas_tpu_torch.models import cnv, lfc
    from brevitas_tpu_torch.nn import QuantConv2d

    rows, checked = {}, {}
    tmp = tempfile.mkdtemp(prefix="export_")
    _reset_launch_counts()
    with checked_kernel_calls(checked):
        # (a) the CLI
        for run, argv in EXPORT_PTQ_RUNS.items():
            keep = {}
            path = os.path.join(tmp, f"{run}.onnx")
            t0 = time.perf_counter()
            result = ptq_calibrate.main(argv + ["--export-path", path, "--device", str(dev)],
                                        keep=keep)
            main_s = time.perf_counter() - t0
            model = keep["model"]
            blob = open(path, "rb").read()
            E.validate_onnx(blob)
            tol = EXPORT_TOL["conv" if "convnet" in run else "linear"]
            if run.endswith("qop"):
                last = model.l3
                with torch.no_grad():
                    step = float(last.input_quant(torch.zeros(1, 64, device=dev)).scale
                                 * last.quant_weight().scale.max())
                tol = (0.0, step)
            x = torch.from_numpy(keep["x_test"]).to(dev)
            check = interpret_against_model(blob, model, x, tol, f"ptq_{run}")
            acc = float(np.mean(check["free"].argmax(-1) == keep["y_test"]))
            _export_row(rows, f"ptq_{run}", blob, keep["stage_ms"]["export"], check,
                        argv[-1])
            rows[f"ptq_{run}"].update(main_s=main_s, ptq_acc=result["ptq_acc"],
                                      interpreted_acc=acc, tol=tol)
            print(f"[export] ptq_{run}: main {main_s:.1f} s; interpreted accuracy {acc} on the "
                  f"{len(keep['y_test'])} test digits, ptq_acc {result['ptq_acc']}")
            if acc != result["ptq_acc"] or result["exported"] != path:
                raise AssertionError(f"ptq_{run}: interpreted accuracy {acc} is not ptq_acc")

        # (b) LFC INT4 after a few QAT steps
        model = lfc(4, 4, 4, dropout=0.0, generator=torch.Generator().manual_seed(0), device=dev)
        rng = np.random.default_rng(0)
        xs = torch.from_numpy(rng.random((EXPORT_LFC_STEPS, LFC_QAT_BATCH, 28, 28, 1),
                                         dtype=np.float32)).to(dev)
        ys = torch.from_numpy(rng.integers(0, 10, (EXPORT_LFC_STEPS, LFC_QAT_BATCH))
                              .astype(np.int32)).to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=LFC_QAT_LR)
        for i in range(EXPORT_LFC_STEPS):
            bnn_pynq.train_step(model, opt, xs[i], ys[i])
        model.eval()
        x = xs[0, :EXPORT_LFC_BATCH].reshape(EXPORT_LFC_BATCH, -1)
        for style, fn in (("qonnx", E.export_qonnx), ("finn", E.export_finn_onnx),
                          ("qcdq", E.export_onnx_qcdq)):
            blob, ms = timed_export(fn, model, x, f"lfc_{style}")
            _export_row(rows, f"lfc_{style}", blob, ms,
                        interpret_against_model(blob, model, x, EXPORT_TOL["linear"],
                                                f"lfc_{style}"), style)
        path = os.path.join(tmp, "lfc.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = E.export_native(model, path)
        native_ms = (time.perf_counter() - t0) * 1e3
        loaded = E.load_native(path)
        for name, entry in loaded.items():
            codes = model.get_submodule(name).quant_weight().int().cpu().numpy().T
            if not np.array_equal(entry["w_int"].astype(np.int64), codes.astype(np.int64)):
                raise AssertionError(f"lfc native: {name}'s integer weights are not the model's")
        rows["lfc_native"] = {"ms": native_ms, "bytes": os.path.getsize(path),
                              "layers": info["layers"]}
        print(f"[export] lfc_native: {native_ms:.1f} ms, {os.path.getsize(path)} bytes, "
              f"{info['layers']} layers (int4 packed); load_native's integer weights equal "
              "the card model's codes")
        t0 = time.perf_counter()
        ts = E.export_torch_qcdq(model, x)
        torch.cuda.synchronize()
        ts_ms = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            got, want = ts(x), model(x)
        ts_err = float((got - want).abs().max())
        rows["lfc_torch_qcdq"] = {"ms": ts_ms, "max_abs_err": ts_err,
                                  "device": str(got.device)}
        print(f"[export] lfc_torch_qcdq: traced on {got.device} in {ts_ms:.1f} ms; against the "
              f"fake-quant forward max |diff| {ts_err:.3g} (bound rtol = atol = "
              f"{EXPORT_TORCH_TOL})")
        if not torch.allclose(got, want, rtol=EXPORT_TORCH_TOL, atol=EXPORT_TORCH_TOL):
            raise AssertionError("lfc_torch_qcdq: the TorchScript twin is not the model")

        # (c) CNV_4W4A
        model = cnv(4, 4, 8, generator=torch.Generator().manual_seed(0), device=dev)
        x_all, _ = bnn_pynq.load_synthetic("train", "cnv", n=256)
        model.train()
        with torch.no_grad():
            model(torch.from_numpy(x_all).to(dev))
        model.eval()
        x = torch.from_numpy(x_all[:EXPORT_CNV_BATCH]).to(dev)
        for style, fn in (("qcdq", E.export_onnx_qcdq), ("finn", E.export_finn_onnx)):
            blob, ms = timed_export(fn, model, x, f"cnv_{style}")
            _export_row(rows, f"cnv_{style}", blob, ms,
                        interpret_against_model(blob, model, x, EXPORT_TOL["conv"],
                                                f"cnv_{style}"), style)

        # (d) the flexml ResNet-18's derived residual walk
        model = resnet["fake_quant_model"]
        x = resnet["x"][:EXPORT_RESNET_BATCH]
        items, _ = export_items(model, x, model(x))
        convs = [it for it in items if isinstance(it, QuantConv2d)]
        strided = [c for c in convs if c.kernel_size == (1, 1) and c.stride == (2, 2)]
        glue = sorted({it[0] for it in items if isinstance(it, tuple)})
        print(f"[export] resnet18 derived walk: {len(items)} items, {len(convs)} convs "
              f"({len(strided)} strided 1 x 1 shortcuts), glue {glue}")
        if len(convs) != RESNET_CONVS or len(strided) != 3 or "add_saved" not in glue:
            raise AssertionError("resnet18: the derived walk is not ResNet-18's")
        blob, ms = timed_export(E.export_onnx_qcdq, model, x, "resnet18_qcdq")
        _export_row(rows, "resnet18_qcdq", blob, ms,
                    interpret_against_model(blob, model, x, EXPORT_TOL["conv"],
                                            "resnet18_qcdq"), "qcdq")
    counts = _launch_counts()
    _record_path("export", counts)
    print(f"[export] launches {counts}; calls held bit for bit against their plain versions: "
          f"{checked}")
    if counts["fake_quant"] == 0 or counts["fake_quant"] != checked["fake_quant"]:
        raise AssertionError(f"export: fake_quant launches {counts['fake_quant']} against "
                             f"{checked['fake_quant']} calls checked")
    others = {k: v for k, v in counts.items() if k not in ("fake_quant", "fake_quant_backward")
              and v}
    if others:
        raise AssertionError(f"export: unexpected launches {others}")
    return {"card": CARD[0], "exports": rows, "launches": counts, "calls_checked": checked}


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


def llama_gemm_sums(rows, m: int, kernel: str = "int8_matmul",
                    kn_count: dict = LLAMA_KN_COUNT) -> dict:
    """A GEMM kernel's times over one Llama forward (prefill, M = 4096) or one
    decode step (M = 16): its 43 launches at their shapes; or over the
    launches ``kn_count`` gives (QuartzNet's 94 a forward at M = 512)."""
    per_kn = {(r["k"], r["n"]): r for r in rows if r["kernel"] == kernel and r["m"] == m}
    sums = {key: sum(per_kn[kn][key] * c for kn, c in kn_count.items())
            for key in ("ms", "plain_ms", "bound_ms", "call_ms")}
    by = {b: sum(per_kn[kn]["bound_ms"] * c for kn, c in kn_count.items()
                 if per_kn[kn]["bound_by"] == b) for b in ("bytes", "operations")}
    sums["bound_by"] = max(by, key=by.get)
    libs = [per_kn[kn]["library_ms"] for kn in kn_count]
    sums["library_ms"] = None if None in libs else sum(
        per_kn[kn]["library_ms"] * c for kn, c in kn_count.items())
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


PHASE_SECONDS = {}  # each phase's wall time, in the report


def timed(name: str, fn, *args, **kw):
    """Run one phase and keep its wall time."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    print(f"[phase] {name}: {PHASE_SECONDS[name]:.1f} s")
    return out


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
    rows = timed("kernels", phase_kernels, dev, peaks)
    crossover = timed("int8_crossover", phase_int8_crossover, dev)
    rows += timed("int4_kernel", phase_int4_kernel, dev, peaks)
    int4_crossover = timed("int4_crossover", phase_int4_crossover, dev)
    attn_rows = timed("attention_kernels", phase_attention_kernels, dev, peaks)
    lstm_rows = timed("lstm_kernels", phase_lstm_kernels, dev, VECTOR_PEAKS[sheet], peaks[0])
    fq_rows = timed("fake_quant_kernels", phase_fake_quant_kernels, dev, peaks[0])
    fq_exhaustive = timed("fake_quant_exhaustive", phase_fake_quant_exhaustive, dev)
    fq_spread = timed("fake_quant_spread", phase_fake_quant_spread, dev)
    serve_out, serve_int8 = timed("serve", phase_serve, dev)
    lfc_launches = timed("lfc", phase_lfc, dev)
    prefill = timed("llama_prefill", phase_llama_prefill, dev)
    decode = {"int8kv": timed("llama_decode_int8kv", phase_llama_decode, dev, None),
              "int4kv": timed("llama_decode_int4kv", phase_llama_decode, dev, 4)}
    w4a8_prefill = timed("llama_w4a8_prefill", phase_llama_prefill, dev, w4a8=True)
    w4a8_decode = timed("llama_w4a8_decode", phase_llama_decode, dev, None, w4a8=True)
    serve_decode = timed("serve_decode", phase_serve_decode, dev)
    llm = {run: timed(f"llm_ptq_{run}", phase_llm_ptq, dev, run) for run in LLM_PTQ_RUNS}
    lstm = {"float32": timed("lstm_qat_float32", phase_lstm_qat, dev),
            "bf16": timed("lstm_qat_bf16", phase_lstm_qat, dev, bf16=True)}
    lfc_qat = {d: timed(f"lfc_qat_{d}", phase_lfc_qat, dev, bf16=d == "bf16")
               for d in ("bf16", "float32")}
    convs = timed("convs", check_convs, dev)
    cnv_qat = {f"int{b}pc_{d}": timed(f"cnv_qat_int{b}pc_{d}", phase_cnv_qat, dev, b,
                                      bf16=d == "bf16")
               for b in CNV_QAT_BITS for d in ("bf16", "float32")}
    trainer = timed("bnn_pynq", phase_bnn_pynq, dev)
    binary_trainer = timed("bnn_pynq_binary", phase_bnn_pynq_binary, dev)
    binary_qat = timed("binary_qat", phase_binary_qat, dev)
    quant_options = timed("quant_options", phase_quant_options, dev)
    exact_route = timed("exact_route", check_exact_route, dev)
    quartznet = timed("quartznet_serving", phase_quartznet_serving, dev)
    mobilenet = {d: timed(f"mobilenet_qat_{d}", phase_mobilenet_qat, dev, bf16=d == "bf16")
                 for d in ("bf16", "float32")}
    ptq = {run: timed(f"ptq_calibrate_{run}", phase_ptq_calibrate, dev, run) for run in PTQ_RUNS}
    resnet_keep = {}
    resnet = timed("flexml_resnet18", phase_flexml_resnet18, dev, resnet_keep)
    exported = timed("export", phase_export, dev, resnet_keep)
    del resnet_keep

    int8_by_path = {"serve": serve_int8, "lfc8": lfc_launches["int8_matmul"],
                    "llama_prefill": prefill["launches"]["int8_matmul"],
                    **{f"llama_decode_{k}": v["launches"]["int8_matmul"]
                       for k, v in decode.items()},
                    **{k: v["launches"]["int8_matmul"] for k, v in serve_decode.items()},
                    "quartznet_serving": quartznet["launches_per_forward"]["int8_matmul"],
                    **{f"llm_ptq_{k}": v["launches_over_main"]["int8_matmul"]
                       for k, v in llm.items()},
                    **{f"ptq_calibrate_{k}": v["launches_over_main"]["int8_matmul"]
                       for k, v in ptq.items()},
                    "flexml_resnet18": resnet["launches_served_forward"]["int8_matmul"]}
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
                      llama_decode_step=llama_gemm_sums(rows, DECODE_BATCH),
                      quartznet_forward=llama_gemm_sums(rows, QN_M,
                                                        kn_count=QUARTZNET_KN_COUNT))
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
                                + w4a8_prefill["launches"]["int8_attention"]
                                + llm["static_kv8"]["launches_over_main"]["int8_attention"]),
        decode_entry,
        lstm_summary(lstm_rows, "quant_lstm_cell", lstm, "brevitas_tpu/kernels/lstm_cell.py:176",
                     "add_f32"),
        lstm_summary(lstm_rows, "quant_lstm_cell_tables", lstm,
                     "brevitas_tpu/kernels/lstm_cell.py:176 (the forward's sigmoid and tanh, "
                     "_cell_fwd_kernel:58)", "build"),
        lstm_summary(lstm_rows, "quant_lstm_cell_backward", lstm,
                     "brevitas_tpu/kernels/lstm_cell.py:224", "direct"),
        *(fake_quant_summary(fq_rows, name, sum(
            PATH_COUNTS[path][name] for path in
            [f"lfc_qat_{d}" for d in lfc_qat] + [f"cnv_qat_{k}" for k in cnv_qat]
            + [f"mobilenet_qat_{d}" for d in mobilenet] + ["quartznet_serving"]
            + [f"binary_qat_{k}" for k in binary_qat] + [f"llm_ptq_{k}" for k in llm]
            + [f"ptq_calibrate_{k}" for k in ptq] + ["flexml_resnet18_fake_quant", "export"]))
          for name in ("fake_quant", "fake_quant_backward")),
    ], "serve": serve_out,
        "llama_prefill": {k: v for k, v in prefill.items() if k != "profile"},
        "llama_decode": {k: {kk: vv for kk, vv in v.items() if kk != "profile"}
                         for k, v in decode.items()},
        "llama_w4a8_prefill": {k: v for k, v in w4a8_prefill.items() if k != "profile"},
        "llama_w4a8_decode": {k: v for k, v in w4a8_decode.items() if k != "profile"},
        "serve_decode": {k: {kk: vv for kk, vv in v.items() if kk != "profile"}
                         for k, v in serve_decode.items()},
        "llm_ptq": {k: {kk: vv for kk, vv in v.items() if kk != "profile"}
                    for k, v in llm.items()},
        "lstm_qat": {d: {k: v for k, v in run.items() if k != "profile"}
                     for d, run in lstm.items()},
        "lfc_qat": {d: {k: v for k, v in run.items() if k != "profile"}
                    for d, run in lfc_qat.items()},
        "cnv_qat": {k: {kk: vv for kk, vv in run.items() if kk != "profile"}
                    for k, run in cnv_qat.items()},
        "convs": convs,
        "bnn_pynq": trainer,
        "bnn_pynq_binary": binary_trainer,
        "binary_qat": {k: {kk: vv for kk, vv in run.items() if kk != "profile"}
                       for k, run in binary_qat.items()},
        "quant_options": quant_options,
        "exact_route": exact_route,
        "quartznet_serving": {k: v for k, v in quartznet.items() if k != "profile"},
        "mobilenet_qat": {d: {k: v for k, v in run.items() if k != "profile"}
                          for d, run in mobilenet.items()},
        "ptq_calibrate": {k: {kk: vv for kk, vv in v.items() if kk != "profile"}
                          for k, v in ptq.items()},
        "flexml_resnet18": {k: v for k, v in resnet.items() if k != "profile"},
        "export": exported,
        "phase_seconds": PHASE_SECONDS, "seconds": time.perf_counter() - t0}
    report["kernels"][-2]["step_forward_spread"] = fq_spread
    report["kernels"][-2]["exhaustive"] = fq_exhaustive
    report["kernels"][-2]["views"] = [r for r in fq_rows if "view" in r]
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
