"""How to launch a frame's shards over several cards: from the caller's
thread one after another (`parallel.mesh.map_blocks`, what the port does),
or each from a host thread of its own (as `torch.nn.parallel.parallel_apply`
does), against one card.

On the first `--cards` cards (4 by default), times B1 (`fused_field`) and a
tiledgrid head's float32 field (`RADNeRF.field`, the May head's widths,
seeded tables) on the points of one 512^2 x 10-sample frame, then whole
frames through `GeneFaceInfer.launch_secc2video`: the torso_sr full frame
(the May lm3d_radnerf_torso_sr configuration, seeded) and the tiledgrid
head-only 512^2 frame. Each reading is the median of REPS, one card and the
two launch modes in turns, with the card's name and power limit:

    python -m genefaceplusplus_tpu_torch.tools.mesh_launch [--cards 4]
"""

import argparse
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPS = 8


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def threaded(pool: ThreadPoolExecutor):
    """`map_blocks` with shards 1.. launched from `pool`'s threads, each
    under its device and stream and the caller's grad mode."""
    from genefaceplusplus_tpu_torch.parallel import mesh as pm

    def map_blocks(mesh, fn, *tensors):
        blocks = [pm.shard_rays(mesh, t) for t in tensors]
        streams, grad = mesh.streams(), torch.is_grad_enabled()
        ready = {d: torch.cuda.current_stream(d) for d in set(mesh.devices)}

        def run(i):
            d, s = mesh.devices[i], streams[i]
            with torch.set_grad_enabled(grad), torch.cuda.device(d), torch.cuda.stream(s):
                s.wait_stream(ready[d])
                shard = [b[i] for b in blocks]
                for b in shard:
                    b.record_stream(s)
                return fn(i, *shard)

        futures = [pool.submit(run, i) for i in range(1, mesh.size)]
        outs = [run(0)] + [f.result() for f in futures]
        single = isinstance(outs[0], torch.Tensor)
        outs = [(o,) if single else o for o in outs]
        for i, out in enumerate(outs):
            d = mesh.devices[i]
            ready[d].wait_stream(streams[i])
            for o in out:
                o.record_stream(ready[d])
        gathered = tuple(torch.cat([out[j].to(mesh.main) for out in outs]) for j in range(len(outs[0])))
        return gathered[0] if single else gathered

    return map_blocks


def ms_by_events(fn, reps: int) -> list:
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def frame_ms(infer, batch, reps: int) -> list:
    out = []
    for i in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infer.launch_secc2video(batch, {"frames_per_dispatch": 1}, i % batch["T"], i % batch["T"] + 1)[0][0].cpu()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, default=4)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mesh_launch: needs CUDA devices")
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, synthetic
    from genefaceplusplus_tpu_torch.inference.pipeline import GeneFaceInfer
    from genefaceplusplus_tpu_torch.models import full_renderer
    from genefaceplusplus_tpu_torch.models.radnerf import (
        MAY_LM3D_RADNERF, MAY_LM3D_RADNERF_SR, MAY_LM3D_RADNERF_TORSO_SR, RADNeRF, RADNeRFConfig)
    from genefaceplusplus_tpu_torch.models.radnerf_torso import TorsoConfig, TorsoField
    from genefaceplusplus_tpu_torch.models.superresolution import Superresolution
    from genefaceplusplus_tpu_torch.ops import fused_field as ff
    from genefaceplusplus_tpu_torch.parallel import mesh as pm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mesh = pm.make_mesh(args.cards, dev)
    pool = ThreadPoolExecutor(max_workers=mesh.size - 1)
    modes = {"caller": pm.map_blocks, "threads": threaded(pool)}
    print(f"{card_line()}; {mesh}; peer access "
          f"{[[int(i == j or torch.cuda.can_device_access_peer(i, j)) for j in range(mesh.size)] for i in range(mesh.size)]}")

    def report(what, res):
        print(f"[mesh_launch] {what}, ms (median of {REPS}; all): " + "; ".join(
            f"{k} {statistics.median(v):.3f} ({', '.join(f'{t:.2f}' for t in v)})" for k, v in res.items()), flush=True)

    g = torch.Generator().manual_seed(3)
    n = 512 * 512 * 10
    rs = np.random.RandomState(0)
    xyz = torch.from_numpy(rs.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)).to(dev)
    dirs = torch.nn.functional.normalize(torch.from_numpy(rs.randn(n, 3).astype(np.float32)).to(dev), dim=-1)
    grid_hp = dict(MAY_LM3D_RADNERF, with_sr=False, grid_type="tiledgrid")
    with torch.no_grad():
        head = RADNeRF(RADNeRFConfig.from_hparams(MAY_LM3D_RADNERF), generator=g).to(dev).eval()
        w = ff.weights_from_params(head)
        cond = head.cal_cond_feat(torch.randn(5, 1, 204, generator=g).to(dev))
        ab, cb = ff.bias_rows(cond, head.get_individual_code(0), w)
        gcfg = RADNeRFConfig.from_hparams(grid_hp)
        grid = RADNeRF(gcfg, generator=g).to(dev).eval()
        gcond = grid.cal_cond_feat(torch.randn(gcfg.smo_win_size, 1, 204, generator=g).to(dev))
        gind = grid.get_individual_code(0)
        ws, biases = pm.replicated(mesh, w), pm.broadcast(mesh, ab, cb)
        grids, gconsts = pm.replicated(mesh, grid), pm.broadcast(mesh, gcond, gind)
        for what, one, shard in (
                ("B1 on 2,621,440 points", lambda: ff.fused_field(xyz, dirs, ab, cb, w),
                 lambda i, x, d: ff.fused_field(x, d, *biases[i], ws[i])),
                ("tiledgrid RADNeRF.field on 2,621,440 points", lambda: grid.field(xyz, dirs, gcond, gind),
                 lambda i, x, d: grids[i].field(x, d, *gconsts[i]))):
            res = {"one card": []}
            res.update({k: [] for k in modes})
            for _ in range(2):  # warm-up, then REPS in turns
                one()
                for fn in modes.values():
                    fn(mesh, shard, xyz, dirs)
            for _ in range(REPS):
                res["one card"] += ms_by_events(one, 1)
                for k, fn in modes.items():
                    res[k] += ms_by_events(lambda fn=fn: fn(mesh, shard, xyz, dirs), 1)
            report(what + " (CUDA events on cuda:0, the shards' copies included)", res)

    # whole frames: the torso_sr full frame and the tiledgrid head-only frame
    xx, yy, zz = np.meshgrid(*([np.linspace(-1, 1, 128)] * 3), indexing="ij")
    occ = (xx ** 2 + (2.2 * yy) ** 2 + (1.4 * zz) ** 2) < 0.16
    grid2d = np.zeros((128, 128), np.float32)
    grid2d[57:, 19:108] = 0.5
    cfg, tcfg = RADNeRFConfig.from_hparams(MAY_LM3D_RADNERF_SR), TorsoConfig.from_hparams(MAY_LM3D_RADNERF_TORSO_SR)
    kw = dict(torso_cfg=tcfg, torso_params=TorsoField(tcfg, generator=g).state_dict(),
              sr_params=Superresolution(3, 256, generator=g).state_dict(), torso_occupancy_2d=grid2d)
    builds = {
        "torso_sr full frame": lambda mesh_: GeneFaceInfer(
            cfg, RADNeRF(cfg, generator=torch.Generator().manual_seed(0)).state_dict(),
            RADNeRFDataset(synthetic(num_frames=24, H=512, W=512, seed=0), smo_win_size=cfg.smo_win_size,
                           with_sr=True), occ, device=dev, mesh=mesh_, **kw),
        "tiledgrid head-only 512^2 frame": lambda mesh_: GeneFaceInfer(
            gcfg, grid.state_dict(), RADNeRFDataset(synthetic(num_frames=24, H=512, W=512, seed=0),
                                                    smo_win_size=gcfg.smo_win_size), occ, device=dev, mesh=mesh_)}
    for what, build in builds.items():
        one, sharded = build(None), build(mesh)
        batch = one.prepare_gt_batch(list(range(8)))
        res = {"one card": []}
        res.update({k: [] for k in modes})
        for _ in range(2):  # warm-up, then in turns
            frame_ms(one, batch, 2)
            for fn in modes.values():
                full_renderer.map_blocks = fn
                frame_ms(sharded, batch, 2)
        for _ in range(REPS):
            res["one card"] += frame_ms(one, batch, 1)
            for k, fn in modes.items():
                full_renderer.map_blocks = fn
                res[k] += frame_ms(sharded, batch, 1)
        full_renderer.map_blocks = pm.map_blocks
        report(what + " (host wall a frame, synchronised)", res)
        del one, sharded
    pool.shutdown()


if __name__ == "__main__":
    main()
