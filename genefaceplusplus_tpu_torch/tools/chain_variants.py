"""The backward chain's build-time choices, compared on the card.

Builds `csrc/fused_field_bwd.cu` as it is and as VARIANTS of its consumer
warpgroups (NCONS, with the producer warpgroup's setmaxnreg share
PRODUCER_REGS) and weight-ring depth (NSTAGE), each from a patched copy of
the source beside copies of its headers under build/chain_variants/, with
the kernels' nvcc flags, and prints each build's ptxas report and layout.
Then, at chip_smoke.py's kernel_bwd inputs (the May lm3d_radnerf head at
full width, random weights from a seed, 1,048,576 points), it runs each
variant on the same train-mode buffers, checks that all of them write the
same operand buffer bit for bit, and times them in turns: ROUNDS passes
forwards and backwards through the list, two timed launches each.

    python -m genefaceplusplus_tpu_torch.tools.chain_variants
"""

import re
import shutil
import statistics
import subprocess

import torch

# name: (NCONS, NSTAGE, PRODUCER_REGS); None keeps the source's value
VARIANTS = {"source": (None, None, None), "ncons2_stage6": (2, 6, 40), "ncons2_stage10": (2, 10, 40),
            "ncons3_stage10": (3, 10, 24), "ncons3_stage13": (3, 13, 24)}
ROUNDS = 4
N_POINTS = 65536 * 16
BOUND_MS = (2 * 984 + 80 + 1 + 68) * N_POINTS / 3.35e12 * 1e3  # chip_smoke.py's CHAIN_BYTES at the H100's HBM rate


def variant_source(src: str, ncons, nstage, producer_regs) -> str:
    for name, value in (("NCONS", ncons), ("NSTAGE", nstage), ("PRODUCER_REGS", producer_regs)):
        if value is not None:
            src, n = re.subn(rf"\b{name} = \d+;", f"{name} = {value};", src)
            if n != 1:
                raise RuntimeError(f"chain_variants: {name} is not set once in fused_field_bwd.cu")
    return src


def inputs(dev):
    """(xyz, train-mode result, weights, g_sigma, g_rgb, g_amb) as
    chip_smoke.bwd_inputs makes them."""
    from genefaceplusplus_tpu_torch.models.radnerf import MAY_LM3D_RADNERF, RADNeRF, RADNeRFConfig
    from genefaceplusplus_tpu_torch.ops import fused_field as ff

    cfg = RADNeRFConfig.from_hparams(MAY_LM3D_RADNERF)
    model = RADNeRF(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    w = ff.weights_from_params(model, bound=cfg.bound)
    g = torch.Generator(device=dev).manual_seed(2)
    xyz = torch.rand((N_POINTS, 3), generator=g, device=dev) * 2.0 - 1.0
    dirs = torch.randn((N_POINTS, 3), generator=g, device=dev)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    grads = [torch.randn(s, generator=g, device=dev) * 1e-2 for s in ((N_POINTS,), (N_POINTS, 3), (N_POINTS, 3))]
    cond = torch.randn((cfg.smo_win_size, cfg.cond_win_size, cfg.cond_in_dim), generator=g, device=dev)
    with torch.no_grad():
        cond_feat = model.cal_cond_feat(cond, torch.full((1, 1), 0.3, device=dev))
        ab, cb = ff.bias_rows(cond_feat, model.get_individual_code(0), w)
        fwd = ff.fused_field_forward_train(xyz, dirs, ab, cb, w)
    return xyz, fwd, w, *grads


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chain_variants: needs a CUDA device")
    from genefaceplusplus_tpu_torch.ops import fused_field as ff

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip() or torch.cuda.get_device_name(0)
    print(f"[chain_variants] {card}")
    source = ff.SOURCES["fused_field_bwd"]
    src = source.read_text()
    root = ff.BUILD_DIR.parent / "chain_variants"
    libs, library = {}, ff._library
    try:
        for name, knobs in VARIANTS.items():
            d = root / name
            d.mkdir(parents=True, exist_ok=True)
            for h in ff.HEADERS:
                shutil.copy(h, d)
            (d / source.name).write_text(variant_source(src, *knobs))
            ff.SOURCES["fused_field_bwd"] = d / source.name
            ff._library.cache_clear()
            lib = ff._library("fused_field_bwd")
            log = ff.build_kernels(["fused_field_bwd"])["fused_field_bwd"].with_suffix(".log").read_text()
            ptxas = "; ".join(x.strip() for x in log.splitlines() if "registers" in x or "spill" in x)
            print(f"[chain_variants] {name}: {ff.chain_config(lib)}; ptxas: {ptxas}")
            libs[name] = lib
        xyz, fwd, w, g_sigma, g_rgb, g_amb = inputs(dev)

        def run(name):
            ff._library = lambda _name, lib=libs[name]: lib
            return ff.fused_field_bwd_chain(xyz, fwd, w, g_sigma, g_rgb, g_amb)

        with torch.no_grad():
            first = run("source").clone()
            for name in libs:
                if not torch.equal(run(name), first):
                    raise SystemExit(f"chain_variants: {name} writes other operands than the source")
            times = {name: [] for name in libs}
            order = list(libs)
            for _ in range(ROUNDS):
                for name in order + order[::-1]:
                    run(name)  # untimed: the variant's first launch after a switch
                    for _ in range(2):
                        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                        start.record()
                        run(name)
                        end.record()
                        torch.cuda.synchronize()
                        times[name].append(start.elapsed_time(end))
        print(f"[chain_variants] every variant writes the source's operands bit for bit; times at {N_POINTS} "
              f"points (bound {BOUND_MS:.4f} ms, bytes):")
        for name, t in times.items():
            ms = statistics.median(t)
            print(f"[chain_variants] {name}: median {ms:.4f} ms (min {min(t):.4f}, max {max(t):.4f}, n={len(t)}); "
                  f"{100.0 * BOUND_MS / ms:.1f} % of the bound")
    finally:
        ff.SOURCES["fused_field_bwd"], ff._library = source, library
        ff._library.cache_clear()


if __name__ == "__main__":
    main()
