"""Where a port kernel's cycles go on the card.

A copy of a CUDA source from ``brevitas_tpu_torch/csrc/`` gets stamps at
marked points: thread 0 of every CTA writes ``%globaltimer`` (ns, common to
the SMs), ``clock64()`` (its SM's cycles) and ``%smid`` to a ``__device__``
array. The copy is built with the port's ``nvcc`` flags into
``brevitas_tpu_torch/csrc/build/probes/`` (ignored by git), bound with
``ctypes`` in place of the wrapper's launcher, and run through the wrapper
at the main path's shapes; the counted call is timed with ``chip_smoke``'s
``cuda_ms``. Variants of a source (edited constants or launch bounds) are
built and run in one process, in turns, so that they are compared on one
card.

    python kernel_probes.py lstm        # quant_lstm_cell: the forward (tables, direct
                                        # chain), and the backward at 4- and 8-column CTAs
    python kernel_probes.py attention   # int8_attention: as built, and capped at 5 CTAs an SM

Needs a card and nvcc; imports nothing of JAX.
"""

import argparse
import ctypes
import importlib
import statistics
import subprocess
import sys

import torch

import chip_smoke as cs
from brevitas_tpu_torch.csrc import build
from brevitas_tpu_torch.kernels import lstm_cell

OUT = build.BUILD_DIR / "probes"
STAMPS = 1 << 20  # 16 words a CTA

STAMP_DEF = r'''
__device__ unsigned long long g_stamps[%d];
__device__ __forceinline__ void stamp(int i) {
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    unsigned long long t;
    unsigned sm;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
    const unsigned long long c = clock64();
    asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(sm));
    const int b = (blockIdx.y * gridDim.x + blockIdx.x) * 16;
    g_stamps[b + 2 * i] = t;
    g_stamps[b + 2 * i + 1] = c;
    if (i == 0) g_stamps[b + 15] = sm;
  }
}
''' % STAMPS

STAMP_READ = r'''
extern "C" int probe_stamps(unsigned long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, n * 8);
}
'''


def insert(src: str, anchor: str, text: str, after: bool = True) -> str:
    if anchor not in src:
        raise RuntimeError(f"probe anchor not found: {anchor!r}")
    return src.replace(anchor, anchor + text if after else text + anchor, 1)


def stamped(name: str, marks) -> str:
    """The source of kernel ``name`` with STAMP_DEF after ``using namespace
    hopper;`` and ``stamp(i);`` at each (anchor, i, after) of ``marks``."""
    src = insert((build.HERE / f"{name}.cu").read_text(), "using namespace hopper;\n", STAMP_DEF)
    for anchor, i, after in marks:
        src = insert(src, anchor, f"  stamp({i});\n", after)
    return src + STAMP_READ


def compile_variant(tag: str, src: str, launcher: str, n_ptr: int, n_int: int):
    """Build ``src`` into a library; returns (library, its launcher bound
    as the wrapper binds it)."""
    OUT.mkdir(parents=True, exist_ok=True)
    for header in build.HERE.glob("*.cuh"):
        (OUT / header.name).write_text(header.read_text())
    cu, so = OUT / f"{tag}.cu", OUT / f"lib{tag}.so"
    cu.write_text(src)
    r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                       capture_output=True, text=True)
    for line in (r.stdout + r.stderr).splitlines():
        if any(w in line for w in ("registers", "spill", "error")):
            print(f"[{tag}] {line.strip()}")
    r.check_returncode()
    lib = ctypes.CDLL(str(so))
    lib.probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn = getattr(lib, launcher)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def read_stamps(lib, n_ctas: int):
    buf = (ctypes.c_ulonglong * (n_ctas * 16))()
    if lib.probe_stamps(buf, n_ctas * 16) != 0:
        raise RuntimeError("reading the stamps failed")
    return [[buf[i * 16 + x] for x in range(16)] for i in range(n_ctas)]


def cycles(rows, a: int, b: int):
    """Medians and extremes of clock64 from stamp a to stamp b, over the
    CTAs that wrote both in the last launch (stamps of earlier launches are
    older than its first start)."""
    t0 = min(r[0] for r in rows)
    v = [r[2 * b + 1] - r[2 * a + 1] for r in rows if r[2 * b] >= t0 and r[2 * a] >= t0]
    return (min(v), statistics.median(v), max(v), len(v)) if v else None


def probe_lstm_forward() -> None:
    """quant_lstm_cell's forward at the QuantLSTM leg's (64, 512), as the
    leg calls it (two addends, a strided float32 xp) on the stage tables
    (sa and ss per gate block) and on the direct chain (per column): stamps
    at the start, after the bulk copy is issued (0), once the gates and
    their acc codes are formed (1), once the tables have landed (2, tables
    only) and before the stores (3)."""
    marks = [("  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;\n"
              "  const bool live", 0, False),
             ("    __syncthreads();  // the barrier's initialisation", 1, False),
             ("    mbar_wait(&bar, 0);\n", 2, True),
             ("    c_new[i] = __fmul_rn(q_c, s_c);\n", 3, False),
             ("    if (!live) return;\n    Cell z;\n", 1, True),
             ("    c_new[i] = z.cn.y;\n", 3, False)]
    lib, fn = compile_variant("lstm_fwd", stamped("quant_lstm_cell", marks),
                              "quant_lstm_cell_launch", 13, 20)
    lstm_cell._forward_launcher = lambda: fn
    dev = torch.device("cuda")
    b, h = 64, 512
    names = ["start", "gates and acc codes", "tables landed", "chain done"]
    for form in ("gate", "column"):
        gates, c, scales, _, _ = cs.lstm_cell_inputs(dev, b, h, seed=b * h, form=form)
        g = torch.Generator(device=dev).manual_seed(1)
        xp = (torch.randn((b, 3, 4 * h), generator=g, device=dev) * 3).unbind(1)[1]
        p = gates - xp
        tables = lstm_cell.quant_lstm_cell_tables(*scales[:5], cs.LSTM_BOUNDS)
        path = "tables" if tables is not None else "direct chain"

        def call():
            return lstm_cell.quant_lstm_cell(xp, c, *scales, cs.LSTM_BOUNDS, recurrent=p,
                                             tables=tables)

        with torch.no_grad():
            t_call = cs.cuda_ms(call)
            for _ in range(3):
                call()
        torch.cuda.synchronize()
        rows = read_stamps(lib, -(-b * h // 256))
        t0 = min(r[0] for r in rows)
        end = max(r[6] for r in rows if r[6] >= t0)
        print(f"== quant_lstm_cell forward {(b, h)} two addends, sa/ss per {form} ({path}): "
              f"the counted call {t_call * 1e3:.2f} us, the kernel's span "
              f"{(end - t0) / 1e3:.2f} us by globaltimer")
        steps = [(0, 1), (1, 2), (2, 3)] if tables is not None else [(0, 1), (1, 3)]
        for a, z in steps:
            cyc = cycles(rows, a, z)
            if cyc:
                print(f"  cycles {names[a]} -> {names[z]}: min {cyc[0]} median {cyc[1]} max "
                      f"{cyc[2]} ({cyc[3]} CTAs)")


def probe_lstm() -> None:
    """quant_lstm_cell_backward at the QuantLSTM leg's (64, 512) in two
    scale forms and at (1024, 512): stamps at the start (0), after the rows
    (1), after the lane sums (2), before the ticket (3), in the last block
    after the ticket (4) and before its final writes (5)."""
    marks = [("  for (int k = 0; k < kSums; ++k) acc[k] = 0.0;\n", 0, True),
             ("  for (int k = 0; k < kSums; ++k) red[k][ty][tx] = acc[k];\n  __syncthreads();\n",
              1, True),
             ("  // 3. thread (term k, column)", 2, False),
             ("  __syncthreads();\n  if (tid == 0) {\n    __threadfence();", 3, False),
             ("  if (!last) return;\n", 4, True),
             ("    *ticket = 0u;", 5, False)]
    src = stamped("quant_lstm_cell", marks)
    libs = {cols: compile_variant(f"lstm_cols{cols}",
                                  src.replace("constexpr int kCols = 4;",
                                              f"constexpr int kCols = {cols};"),
                                  "quant_lstm_cell_backward_launch", 17, 18)
            for cols in (4, 8)}
    dev = torch.device("cuda")
    names = ["start", "rows done", "lane sums", "partials written", "last block in",
             "last block done"]
    for b, h, form in ((64, 512, "gate"), (64, 512, "column"), (1024, 512, "column")):
        gates, c, scales, dh, dcn = cs.lstm_cell_inputs(dev, b, h, seed=b * h, form=form)
        args = (gates, c, *scales, dh, dcn, cs.LSTM_BOUNDS)
        for cols in (4, 8, 8, 4):
            lib, fn = libs[cols]
            lstm_cell._backward_launcher = lambda: fn  # noqa: B023
            t_call = cs.cuda_ms(lambda: lstm_cell.quant_lstm_cell_backward(*args))
            for _ in range(3):
                lstm_cell.quant_lstm_cell_backward(*args)
            torch.cuda.synchronize()
            rows = read_stamps(lib, -(-h // cols))
            t0 = min(r[0] for r in rows)
            end = max(r[10] for r in rows if r[10] >= t0)
            print(f"== quant_lstm_cell_backward {(b, h)} sa/ss per {form}, {cols} columns a "
                  f"CTA: the counted call {t_call * 1e3:.2f} us, the kernel's span "
                  f"{(end - t0) / 1e3:.2f} us by globaltimer")
            for a in range(5):
                cyc = cycles(rows, a, a + 1)
                if cyc:
                    print(f"  cycles {names[a]} -> {names[a + 1]}: min {cyc[0]} median "
                          f"{cyc[1]} max {cyc[2]} ({cyc[3]} CTAs)")


def probe_attention() -> None:
    """int8_attention at the prefill shape (BH 128, T 512, D 64, causal):
    stamps at the start (0), at each pass's start (1-3) and at the end (4);
    the kernel as built against one capped at 5 CTAs an SM at DC 1."""
    attn = importlib.import_module("brevitas_tpu_torch.kernels.int8_attention")
    marks = [("  const int i_last = min(q0 + kRows, Tq) - 1;\n", 0, False),
             ("  const float pv_scale = __fmul_rn(p_scale, v_scale);\n", 4, False)]
    src = stamped("int8_attention", marks)
    src = insert(src, "  for (int pass = 0; pass < 3; ++pass) {\n", "    stamp(1 + pass);\n")
    bounds = "__global__ void __launch_bounds__(kThreads)\nint8_attention_kernel"
    if bounds not in src:
        raise RuntimeError("probe anchor not found: the kernel's launch bounds")
    variants = {"as built": src,
                "capped at 5 CTAs an SM": src.replace(
                    bounds, "__global__ void __launch_bounds__(kThreads, DC == 1 ? 5 : 1)\n"
                            "int8_attention_kernel")}
    libs = {name: compile_variant(f"attn{i}", v, "int8_attention_launch", 6, 7)
            for i, (name, v) in enumerate(variants.items())}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    bh, tq, tk, d = cs.ATTN_SHAPES[0][:4]
    q = torch.randint(-127, 128, (bh, tq, d), generator=g, device=dev, dtype=torch.int8)
    k = torch.randint(-127, 128, (bh, tk, d), generator=g, device=dev, dtype=torch.int8)
    v = torch.randint(-127, 128, (bh, tk, d), generator=g, device=dev, dtype=torch.int8)
    qk = torch.tensor(3.0 / (127 ** 2 / 3 * d ** 0.5), device=dev)
    ps, vs = torch.tensor(0.25 / 255, device=dev), torch.tensor(0.02, device=dev)
    args = (q, k, v, qk, ps, vs, 255, True, 1)
    want, want_codes = attn.int8_attention_reference(*args, return_codes=True)
    for name in ("as built", "capped at 5 CTAs an SM", "capped at 5 CTAs an SM", "as built"):
        attn._attention_launcher = lambda: libs[name][1]  # noqa: B023
        got, got_codes = attn.int8_attention(*args, return_codes=True)
        flips, _ = cs.check_codes(got, got_codes, want, want_codes, v, ps * vs, name)
        print(f"== int8_attention {(bh, tq, tk, d)} causal, {name}: the counted call "
              f"{cs.cuda_ms(lambda: attn.int8_attention(*args)) * 1e3:.2f} us, {flips} flips")
    lib, fn = libs["as built"]
    attn._attention_launcher = lambda: fn
    for _ in range(3):
        attn.int8_attention(*args)
    torch.cuda.synchronize()
    n_qblocks = -(-tq // 64)
    rows = read_stamps(lib, bh * n_qblocks)
    t0 = min(r[0] for r in rows)
    print(f"  the kernel's span {(max(r[8] for r in rows) - t0) / 1e3:.2f} us by globaltimer")
    for qb in range(n_qblocks):  # block x runs query block n_qblocks - 1 - x / BH
        sel = [rows[i] for i in range(len(rows)) if n_qblocks - 1 - i // bh == qb]
        med = [statistics.median(r[2 * (s + 1) + 1] - r[2 * s + 1] for r in sel)
               for s in range(4)]
        print(f"  query block {qb} ({qb + 1} key tiles): starts {min(r[0] for r in sel) - t0}"
              f"-{max(r[0] for r in sel) - t0} ns, ends by {max(r[8] for r in sel) - t0} ns; "
              f"median cycles: setup {med[0]}, pass 1 {med[1]}, pass 2 {med[2]}, "
              f"pass 3 {med[3]}")
    by_sm = {}
    for r in rows:
        by_sm.setdefault(r[15], []).append(r[8] - r[0])
    busy = sorted(sum(x) for x in by_sm.values())
    print(f"  {len(by_sm)} SMs; each SM's sum of CTA time, us: min {busy[0] / 1e3:.1f} median "
          f"{statistics.median(busy) / 1e3:.1f} max {busy[-1] / 1e3:.1f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_probes: CUDA is not available; this script runs on a card",
              file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("kernel", choices=["lstm", "attention"])
    kernel = parser.parse_args().kernel
    cs.phase_card()
    if kernel == "lstm":
        probe_lstm_forward()
    {"lstm": probe_lstm, "attention": probe_attention}[kernel]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
