#!/usr/bin/env python3
"""Where a block of the selective scan's backward spends its time.

    python3 tools/ssm_bwd_split.py SRC LABEL

SRC is a ``src`` directory holding ``repro_torch`` (this checkout's, or the
first, simple backward's, unpacked with ``git archive``); LABEL names it in
the output.  The tool writes copies of that tree's ``csrc/ssm_scan_bwd.cu``
into ``build/repro_torch/split/LABEL/``, builds them with the tree's own nvcc
flags (one nvcc each, all at once) and runs them at the two-layer Jamba's
training shape (bf16, Bt 8, T 256, Din 8192, N 16).  The copies are never
part of the package.

- The split: ``clock64`` reads between the parts of a chunk (the tool knows
  both sources' layouts).  The first thread of every block and the first of
  its middle warp add up the clocks of each part over the chunks.
- The ablations (this design's layout only): one copy each with one part
  taken out (the dB / dC butterfly, the du / ddt reduce-scatter, the
  checkpoint walk, the exponentials, the block sums of dB and dC).  Their
  results are wrong; only their times count, beside the intact copy's.

Prints one JSON line: the clocks a chunk of each part, averaged over the
blocks, and their shares; the intact, instrumented and ablated copies' ms
(CUDA events, launch by launch, in turns, twice); whether the instrumented
copy's gradients are bit-equal to the tree's.  Needs one CUDA card.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

SHAPE = (8, 256, 8192, 16)   # Bt, T, Din, N

MARK = ("  long long acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
        "  long long tk = clock64();\n"
        "#define MARK(i) { const long long now = clock64(); acc[i] += now - tk; tk = now; }\n")
WRITE = ("  MARK(7)\n"
         "  if (threadIdx.x == 0 || threadIdx.x == blockDim.x / 2) {\n"
         "    long long* p = prof + ((static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x)"
         " * 2 + (threadIdx.x != 0)) * 8;\n"
         "    for (int i = 0; i < 8; ++i) p[i] = acc[i];\n"
         "  }\n")
END = "}\n\n// The partials summed in a fixed order"   # the reverse kernel's last line
SETTER = ('extern "C" {\n'
          "void ssm_scan_bwd_set_prof(void* p) { g_prof = static_cast<long long*>(p); }\n")

# each layout: its part names, (anchor, text put after it) pairs, the launch
# and the signature to extend with the clock buffer
LAYOUTS = {
    # the first, simple backward: synchronous staging, segment sums between two barriers
    "simple": (["stage", "checkpoint walk", "recompute", "reverse walk", "segment sums",
                "du / ddt stores", "unused", "tail"], [
        ("               int Tlen, int Din, int N) {\n", MARK),
        ("      cs[e] = ok ? to_float(C[o]) : 0.f;\n    }\n    __syncthreads();\n",
         "    MARK(0)\n"),
        ("          for (int tt = j * SEG; tt < end; ++tt) advance(h, tt);\n        }\n      }\n"
         "    }\n", "    MARK(1)\n"),
        ("          for (int s = 0; s < STATES; ++s) hist[i][s] = h[s];\n        }\n      }\n",
         "      MARK(2)\n"),
        ("          *reinterpret_cast<float4*>(w + NP) = make_float4(vc[0], vc[1], vc[2], vc[3]);\n"
         "        }\n      }\n", "      MARK(3)\n"),
        ("      __syncthreads();                         // wr is the next segment's\n",
         "      MARK(4)\n"),
        ("        ddelta[o] = dds[e];\n      }\n    }\n", "    MARK(5)\n"),
    ], ("      Tlen, Din, N);", "      Tlen, Din, N, g_prof);"),
        ("               int Tlen, int Din, int N) {",
         "               int Tlen, int Din, int N, long long* __restrict__ prof) {")),
    # this design: a cp.async stage, the chunk's sums and stores between walks
    "ring": (["wait + barrier", "between walks", "barrier + stage issue", "checkpoint walk",
              "recompute", "reverse walk", "unused", "tail"], [
        ("               int Tlen, int Din, int N, int vec) {\n", MARK),
        ("    __syncthreads();                           // ... everyone's; the walk of chunk k"
         " + 1 is done\n", "    MARK(0)\n"),
        ("    if (k < 0) break;\n", "    MARK(1)\n"),
        ("    if (k > 0) stage(k - 1);\n", "    MARK(2)\n"),
        ("      for (int i = 0; i < SEG; ++i) advance(h, a, j * SEG + i);\n    }\n",
         "    MARK(3)\n"),
        ("        for (int s = 0; s < STATES; ++s) hist[i][s] = h[s];\n      }\n",
         "      MARK(4)\n"),
        ("make_float2(pdu[0] * wg.y + wg.z * dskip, pdd[0]);\n        }\n      }\n",
         "      MARK(5)\n"),
    ], ("      Tlen, Din, N, vec);", "      Tlen, Din, N, vec, g_prof);"),
        ("               int Tlen, int Din, int N, int vec) {",
         "               int Tlen, int Din, int N, int vec, long long* __restrict__ prof) {")),
}

# this design's parts, each taken out of one copy: (old, new) replacements
ABLATIONS = {
    "dB / dC butterfly": [(
        "#pragma unroll\n          for (int s = 0; s < 2; ++s) {\n"
        "            v[s] += __shfl_xor_sync(FULL, v[s + 2], 16);\n"
        "            v[STATES + s] += __shfl_xor_sync(FULL, v[STATES + s + 2], 16);\n"
        "          }\n"
        "          v[0] += __shfl_xor_sync(FULL, v[1], 8);\n"
        "          v[STATES] += __shfl_xor_sync(FULL, v[STATES + 1], 8);\n"
        "          const float send = hi ? v[0] : v[STATES];\n"
        "          float keep = hi ? v[STATES] : v[0];\n"
        "          keep += __shfl_xor_sync(FULL, send, 4);\n"
        "#pragma unroll\n"
        "          for (int o = 2; o >= L; o >>= 1) keep += __shfl_xor_sync(FULL, keep, o);\n",
        "          const float keep = v[0] + v[STATES];\n")],
    "du / ddt reduce-scatter": [(
        "          butterfly<GRP, 1, L>(pdu, g);\n          butterfly<GRP, 1, L>(pdd, g);\n", "")],
    "checkpoint walk": [("    for (int j = 0; j + 1 < nseg; ++j) {",
                         "    for (int j = 0; j + 1 < 0; ++j) {")],
    "exponentials": [("      a[s] = ex2(dv * a2[s]);", "      a[s] = 1.f + dv * a2[s];")],
    "block sums of dB, dC": [("      for (int e = tid; e < CHUNK * RW / 4; e += THREADS) {",
                              "      for (int e = tid; e < 0; e += THREADS) {")],
}


def _replace_once(text: str, old: str, new: str, what: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"ssm_bwd_split: {what}: {old[:60]!r} not found once")
    return text.replace(old, new)


def instrument(text: str):
    """(layout, part names, the source with clock64 reads and a clock buffer)."""
    layout = "ring" if "cp_async_commit" in text else "simple"
    names, marks, launch, signature = LAYOUTS[layout]
    for anchor, extra in marks:
        text = _replace_once(text, anchor, anchor + extra, f"the {layout} layout")
    for old, new in (launch, signature, (END, WRITE + END),
                     ('extern "C" {\n', SETTER),
                     ("template <typename T, int L>\nint launch_l(",
                      "long long* g_prof = nullptr;\n\n"
                      "template <typename T, int L>\nint launch_l(")):
        text = _replace_once(text, old, new, f"the {layout} layout")
    return layout, names, text


def ablated(text: str):
    """{part: the source with that part taken out} (this design only)."""
    out = {}
    for part, pairs in ABLATIONS.items():
        copy = text
        for old, new in pairs:
            copy = _replace_once(copy, old, new, part)
        out[part] = copy
    return out


def main() -> int:
    src, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        print("ssm_bwd_split: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssm_scan as ks

    out_dir = Path(__file__).resolve().parents[1] / "build" / "repro_torch" / "split" / label
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "ssm_scan_bwd.cu").read_text()
    layout, names, split_text = instrument(source)
    parts = ablated(source) if layout == "ring" else {}
    copies = {"intact": source, "split": split_text,
              **{f"ablate{i}": text for i, text in enumerate(parts.values())}}
    procs = {}
    for name, text in copies.items():
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.flags("ssm_scan_bwd"), "-o", str(out_dir / f"{name}.so"),
             str(out_dir / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for name, proc in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"ssm_bwd_split: the {name} copy did not build:\n{output}")
    libs = {}
    for name in copies:
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.ssm_scan_bwd.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.ssm_scan_bwd.restype = ctypes.c_int
        libs[name] = lib
    libs["split"].ssm_scan_bwd_set_prof.argtypes = [ctypes.c_void_p]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bt, t, din, n = SHAPE
    u = torch.randn((bt, t, din), generator=gen, device=dev).bfloat16()
    delta = torch.rand((bt, t, din), generator=gen, device=dev) * 0.1
    A = -(torch.rand((din, n), generator=gen, device=dev) + 0.5)
    B, C = (torch.randn((bt, t, n), generator=gen, device=dev).bfloat16() for _ in range(2))
    D = torch.randn((din,), generator=gen, device=dev)
    h0 = torch.randn((bt, din, n), generator=gen, device=dev)
    args = (u, delta, A, B, C, D, h0)
    _, _, ckpt = ks.ssm_scan_hopper(*args, checkpoints=True)
    dy = torch.randn((bt, t, din), generator=gen, device=dev).bfloat16()
    dhT = torch.randn((bt, din, n), generator=gen, device=dev)
    want = ks.ssm_scan_bwd_hopper(*args, ckpt, dy, dhT)

    nblk = -(-din // ks.CHANNELS)
    prof = torch.zeros((bt, nblk, 2, 8), dtype=torch.int64, device=dev)
    libs["split"].ssm_scan_bwd_set_prof(prof.data_ptr())
    got = [torch.empty_like(x) for x in args]             # du, ddelta, dA, dB, dC, dD, dh0
    work = torch.empty(ks.bwd_workspace(bt, t, din, n), dtype=torch.float32, device=dev)
    ptrs = [x.data_ptr() for x in (*args[:6], ckpt, dy, dhT, *got, work)]

    def call(name):
        code = libs[name].ssm_scan_bwd(*ptrs, bt, t, din, n, 1,
                                       torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"the {name} copy: CUDA error {code}")

    def ms(name, iters=50):
        for _ in range(3):
            call(name)
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            call(name)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    call("split")
    torch.cuda.synchronize()
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    times = {name: [] for name in copies}
    for _ in range(2):                                    # in turns, twice
        for name in copies:
            times[name].append(ms(name))
    prof.zero_()
    call("split")
    torch.cuda.synchronize()
    chunks = ks.n_chunks(t)
    out = {"tree": label, "layout": layout, "device": torch.cuda.get_device_name(0),
           "shape": SHAPE, "intact_ms": times["intact"], "instrumented_ms": times["split"],
           "ablated_ms": {part: times[f"ablate{i}"] for i, part in enumerate(parts)},
           "bit_equal": equal}
    for who, name in ((0, "first_thread"), (1, "middle_warp")):
        clocks = prof[:, :, who].double().mean((0, 1)) / chunks
        total = float(clocks.sum())
        out[f"{name}_clocks_a_chunk"] = {p: float(c) for p, c in zip(names, clocks)
                                         if p != "unused"}
        out[f"{name}_share"] = {p: float(c) / total for p, c in zip(names, clocks)
                                if p != "unused"}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
