"""The H.264 encoder kernel's time on the card, split by stage, beside its
build-time variants.

Builds `csrc/h264_intra.cu` as it is and as VARIANTS, each from a patched
copy under build/h264_variants/ with the kernels' nvcc flags, and prints
each build's ptxas report:

- "stamped": thread 0 of each block reads `clock64()` after every
  `__syncthreads();` and before every `// stage ...` comment line of the
  source, and adds the cycles since its previous reading to that site's
  sum (a global 64-bit atomic add, so the stamps cost a little time of
  their own). Thread 0 runs the macroblock chain, so each site's sum is
  the chain's (or the block's, between barriers) stage that ends there;
- "chain": `CONSUMERS` set to 0, so the chain runs alone and nothing
  writes the macroblocks' bits (its bytes are not checked): the chain's
  time beside the whole kernel's.

Then it runs each build on INPUTS (8 frames a case but the last:
synthetic_face at 512^2; box-blurred noise whose bytes a frame come near the served renders
of random weights; 8 --debug-sized 1536x512 panels of a dense frame, a face
and black; one `testing.wide_frames` frame, whose slice words lie past
shared memory), checks that every build but "chain" writes the source's bytes
(the framed units, compacted), and times the main path's
launch (`h264_intra`: framed units) in turns by CUDA events: ROUNDS passes
forwards and backwards through the builds, REPS launches each.

    python -m genefaceplusplus_tpu_torch.tools.h264_variants
"""

import ctypes
import re
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

VARIANTS = ("source", "stamped", "chain")
ROUNDS = 3
REPS = 10
SIZE = 512
DENSE_BOX = 2  # the box blur's width: ~180 KB a 512^2 frame at QP 22 (the served renders: ~209 KB)
STAMP_SITES = 64


def dense_frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """Noise box-blurred over DENSE_BOX pixels and stretched back: texture
    everywhere, few macroblocks past the I_PCM escape."""
    k = DENSE_BOX
    x = np.random.RandomState(seed).randint(0, 256, (n, h + k, w + k, 3)).astype(np.float64)
    c = np.pad(np.cumsum(np.cumsum(x, 1), 2), ((0, 0), (1, 0), (1, 0), (0, 0)))
    s = (c[:, k:, k:] - c[:, :-k, k:] - c[:, k:, :-k] + c[:, :-k, :-k]) / (k * k)
    return np.clip((s[:, :h, :w] - 128) * k * 0.55 + 128, 0, 255).astype(np.uint8)


def inputs() -> dict:
    from genefaceplusplus_tpu_torch.data.synthetic_face import synthetic_face
    from genefaceplusplus_tpu_torch.testing import WIDE, wide_frames

    ds = synthetic_face(num_frames=8, size=SIZE, seed=2)
    faces = np.stack([s["gt_img"] for s in ds["train_samples"] + ds["val_samples"]])[:8]
    dense = dense_frames(8, SIZE, SIZE, 0)
    panels = np.concatenate([dense, faces, np.zeros_like(faces)], axis=2)
    return {"face 512^2": faces, "dense 512^2": dense, "panels 512x1536": panels, f"wide 48x{WIDE}": wide_frames()}


def stamped_source(src: str) -> tuple:
    """(the source with the stamps, the sites' descriptions)."""
    sites = []

    def stamp(desc: str) -> str:
        sites.append(desc)
        return (f"if (threadIdx.x == 0) {{ long long gfpp_now = clock64(); atomicAdd(&gfpp_stamps[{len(sites) - 1}], "
                "(unsigned long long)(gfpp_now - gfpp_last)); gfpp_last = clock64(); }")

    lines = src.split("\n")
    last_include = max(i for i, line in enumerate(lines) if line.startswith("#include"))
    out = []
    for i, line in enumerate(lines):
        if i > last_include:
            m = re.match(r"\s*// stage (\w+)", line)
            if m:
                out.append(stamp(f"{m.group(1)} (line {i + 1})"))
            if "__syncthreads();" in line:
                line = line.replace("__syncthreads();", "__syncthreads(); " + stamp(f"barrier (line {i + 1})"), 1)
        out.append(line)
        if i == last_include:
            out.append(f"__device__ unsigned long long gfpp_stamps[{STAMP_SITES}];\n__shared__ long long gfpp_last;")
    if len(sites) > STAMP_SITES:
        raise RuntimeError(f"h264_variants: {len(sites)} stamp sites, at most {STAMP_SITES}")
    text = "\n".join(out)
    head = re.search(r"h264_intra_kernel\([^)]*\)\s*\{", text)
    if head is None:
        raise RuntimeError("h264_variants: no h264_intra_kernel definition in the source")
    text = text[:head.end()] + "\n  if (threadIdx.x == 0) gfpp_last = clock64();" + text[head.end():]
    text += ("\nextern \"C\" int gfpp_h264_stamps(unsigned long long* out, int n) {\n"
             f"  static unsigned long long zero[{STAMP_SITES}];\n"
             "  cudaMemcpyFromSymbol(out, gfpp_stamps, n * sizeof(unsigned long long));\n"
             "  cudaMemcpyToSymbol(gfpp_stamps, zero, sizeof(zero));\n"
             "  return (int)cudaGetLastError();\n}\n")
    return text, sites


def variant_source(name: str, src: str) -> tuple:
    if name == "source":
        return src, []
    if name == "stamped":
        return stamped_source(src)
    out, n = re.subn(r"\bCONSUMERS = \d+;", "CONSUMERS = 0;", src)
    if n != 1:
        raise RuntimeError("h264_variants: CONSUMERS is not set once in h264_intra.cu")
    return out, []


def main():
    if not torch.cuda.is_available():
        raise SystemExit("h264_variants: needs a CUDA device")
    from genefaceplusplus_tpu_torch.ops import h264_encode as he

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip() or torch.cuda.get_device_name(0)
    print(f"[h264_variants] {card}")
    src = he.SOURCE.read_text()
    root = Path(he.BUILD_DIR).parent / "h264_variants"
    original, library = he.SOURCE, he._library
    libs, sites = {}, {}
    try:
        for name in VARIANTS:
            text, where = variant_source(name, src)
            d = root / name
            d.mkdir(parents=True, exist_ok=True)
            (d / original.name).write_text(text)
            he.SOURCE = d / original.name
            he._library.cache_clear()
            libs[name], sites[name] = he._library(), where
            for line in Path(he.library_path()).with_suffix(".log").read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[h264_variants] {name} ptxas: {line.strip()}")
        frames = {k: torch.from_numpy(v).to(dev) for k, v in inputs().items()}

        def use(name):
            he._library = lambda lib=libs[name]: lib

        def units(name, x):
            use(name)
            return he.copy_units(*he.h264_intra(x, 0))

        runs = {name: (lambda x, name=name: (use(name), he.h264_intra(x, 0))) for name in libs if name != "stamped"}
        for case, x in frames.items():
            want_units = units("source", x)
            for name in libs:
                if name not in ("source", "chain") and units(name, x) != want_units:
                    raise SystemExit(f"h264_variants: {name} writes other bytes than the source on {case}")
            order = list(runs)
            times = {n: [] for n in order}
            for r in range(ROUNDS):
                for name in (order if r % 2 == 0 else order[::-1]):
                    for _ in range(REPS):
                        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                        e0.record()
                        runs[name](x)
                        e1.record()
                        torch.cuda.synchronize()
                        times[name].append(e0.elapsed_time(e1))
            print(f"[h264_variants] {card}; {case} ({x.shape[0]} x {x.shape[1]}x{x.shape[2]}, "
                  f"{len(want_units) // x.shape[0]:,} bytes a frame framed): "
                  + ", ".join(f"{n} {statistics.median(t):.4f} ms (min {min(t):.4f})" for n, t in times.items())
                  + f"; medians of {ROUNDS * REPS} by CUDA events, in turns")
            lib = libs["stamped"]
            lib.gfpp_h264_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
            buf = (ctypes.c_ulonglong * STAMP_SITES)()
            lib.gfpp_h264_stamps(buf, STAMP_SITES)  # reset
            use("stamped")
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(REPS):
                he.h264_intra(x, 0)
            e1.record()
            torch.cuda.synchronize()
            lib.gfpp_h264_stamps(buf, STAMP_SITES)
            blocks = REPS * x.shape[0] * (-(-x.shape[1] // 16))
            cycles = [buf[i] / blocks for i in range(len(sites["stamped"]))]
            total = sum(cycles)
            print(f"[h264_variants] {case}: stamped {e0.elapsed_time(e1) / REPS:.4f} ms a launch; thread 0's "
                  f"cycles a block by the site that ends each span, {total:,.0f} in all:")
            for desc, c in zip(sites["stamped"], cycles):
                print(f"[h264_variants]   {desc}: {c:,.0f} ({c / total:.1%})")
    finally:
        he.SOURCE, he._library = original, library
        he._library.cache_clear()


if __name__ == "__main__":
    main()
