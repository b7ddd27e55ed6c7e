#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card and check it.

Run from the repository root on a machine with a card and the CUDA toolkit:

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result:

1. build   - compile every CUDA kernel under brevitas_tpu_torch/csrc (one
             nvcc per source, all at once) and print the time and ptxas report.
2. card    - the card's name and power limit, as nvidia-smi reports them.
3. kernels - each kernel at the slice's shapes (M in {1, 128, 1024}, (K, N) in
             {(784, 1024), (1024, 1024), (1024, 10)}) on random full-range
             codes, held against its plain PyTorch version on the card: int8
             bit for bit, w4a16 within 1e-5 * sum|bf16(x)||w| * |w_scale|.
             Median times (CUDA events) of the kernel, the plain version and one
             library call, beside the least time the card could take.
4. serve   - examples.serve.main at LFC's full widths (512 requests, batch
             128); int8_matmul must launch 4 times per batch plus the warm-up
             batch. One batch is compared with a CPU copy of the served model,
             which takes the plain path.
5. lfc     - LFC 4-bit (w4a16 twins) and LFC 8-bit (carried-grid int8 twins)
             calibrated, converted and served at batch 1024; 4 launches each,
             compared with CPU copies.
6. report  - one {"kernels": [...]} line; the last line is
             {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

The comparison with a CPU copy is made layer by layer, each serving layer of
the copy fed the card's input to that layer (int8 layers must match exactly,
w4a16 layers within the tolerance above), and end to end on the logits.
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
    for m in SHAPES_M:
        for k, n in SHAPES_KN:
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


def profile_batches(model, batch: np.ndarray, what: str, n: int = 5) -> None:
    """Where one served batch's time goes: device time by kernel, from
    torch.profiler over ``n`` batches (host copy in and out included), beside
    the wall time per batch; the rest of the wall time the card is idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.from_numpy(batch)
    with torch.no_grad():
        model(x.cuda()).cpu()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                model(x.cuda()).cpu()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
    # device-side activities only (kernels, copies, memsets): the host ops
    # that launched them carry the same time again
    rows = [(e.key, e.self_device_time_total / 1e3 / n) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("Activity Buffer")]
    busy_ms = sum(t for _, t in rows)
    top = ", ".join(f"{k[:40]} {t:.4f}" for k, t in sorted(rows, key=lambda r: -r[1])[:6])
    print(f"[{what}] profile per batch of {batch.shape[0]}: device busy {busy_ms:.4f} ms "
          f"of {wall_ms:.4f} ms wall under the profiler (idle share "
          f"{1 - busy_ms / wall_ms:.3f}); top device ms: {top}")


def phase_serve(dev):
    from brevitas_tpu_torch import graph as G
    from brevitas_tpu_torch import kernels as K
    from brevitas_tpu_torch.examples import serve

    K.int8_matmul.launches = K.int4_weight_only_matmul.launches = 0
    out = serve.main(["--requests", "512", "--batch-size", str(SERVE_BATCH)])
    n8, n4 = K.int8_matmul.launches, K.int4_weight_only_matmul.launches
    expected = 4 * (out["batches"] + 1)
    print(f"[serve] int8_matmul launches {n8} (expected {expected} = 4 x "
          f"({out['batches']} batches + 1 warm-up)), int4_weight_only_matmul {n4}")
    if n8 != expected or n4 != 0:
        raise AssertionError("serve: the int8 kernel was not launched on every layer")
    model = serve.build_int8_model(torch.Generator().manual_seed(0), dev)
    G.convert_integer_inference(model)
    batch = np.random.default_rng(0).random((SERVE_BATCH, 28, 28, 1), dtype=np.float32)
    compare_with_cpu_copy(model, batch, "serve")
    profile_batches(model, batch, "serve")
    return out, n8


def phase_lfc(dev):
    from brevitas_tpu_torch import graph as G
    from brevitas_tpu_torch import kernels as K
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
        K.int8_matmul.launches = K.int4_weight_only_matmul.launches = 0
        with torch.no_grad():
            model(torch.from_numpy(batch).to(dev))
        torch.cuda.synchronize()
        counts = {"int8_matmul": K.int8_matmul.launches,
                  "int4_weight_only_matmul": K.int4_weight_only_matmul.launches}
        print(f"[lfc] {bits}-bit batch {LFC_BATCH}: launches {counts}")
        other = "int8_matmul" if kernel != "int8_matmul" else "int4_weight_only_matmul"
        if counts[kernel] != 4 or counts[other] != 0:
            raise AssertionError(f"lfc {bits}-bit: expected 4 {kernel} launches")
        launches[kernel] = counts[kernel]
        compare_with_cpu_copy(model, batch, f"lfc{bits}")
        profile_batches(model, batch, f"lfc{bits}")
    return launches


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
    serve_out, serve_int8 = phase_serve(dev)
    lfc_launches = phase_lfc(dev)
    report = {"kernels": [
        kernel_summary(rows, "int8_matmul", SERVE_BATCH,
                       serve_int8 + lfc_launches["int8_matmul"],
                       "brevitas_tpu_torch/csrc/int8_matmul.cu",
                       "brevitas_tpu/kernels/int_matmul.py:90",
                       "torch._int_mm needs N % 8 == 0; LFC's head has N = 10"),
        kernel_summary(rows, "int4_weight_only_matmul", LFC_BATCH,
                       lfc_launches["int4_weight_only_matmul"],
                       "brevitas_tpu_torch/csrc/int4_weight_only_matmul.cu",
                       "brevitas_tpu/kernels/int4.py:229"),
    ], "serve": serve_out, "seconds": time.perf_counter() - t0}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
