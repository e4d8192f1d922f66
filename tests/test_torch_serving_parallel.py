"""A frame over a device mesh (`parallel/mesh.py`, `ShardedFrameRenderer`,
`stream_infer(mesh=)`), on an 8-shard CPU mesh.

The counterparts of tests/test_serving_parallel.py (the port's sharded frame
against JAX's single-device frame, at JAX's sizes and atol 3e-4: plain, with
compact_frac 0.9 and color_topk 8, and the head crop) and of
tests/test_streaming.py's two mesh tests (streamed uint8 frames within one
level of the unsharded port's, head-crop flags equal). Beyond JAX's: live
samples packed into the central shards under a global budget that covers
them give the unsharded frame, bit for bit (a per-shard budget would drop
samples there); the mesh helpers; `make_mesh` refusing more cards than
exist; `init_distributed` over two CPU processes."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genefaceplusplus_tpu.models import full_renderer as j_fr
from genefaceplusplus_tpu.models.radnerf import RADNeRF as JRADNeRF
from genefaceplusplus_tpu.models.radnerf import RADNeRFConfig as JConfig
from genefaceplusplus_tpu.models.renderer import RenderOptions as JOptions
from genefaceplusplus_tpu.utils.rays import get_bg_coords, get_rays
from genefaceplusplus_tpu_torch.inference.serving import ShardedFrameRenderer, stream_infer
from genefaceplusplus_tpu_torch.models import full_renderer as t_fr
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF as TRADNeRF
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRFConfig as TConfig
from genefaceplusplus_tpu_torch.models.renderer import RenderOptions as TOptions
from genefaceplusplus_tpu_torch.parallel import mesh as pm
from genefaceplusplus_tpu_torch.testing import tiny_infer
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params

ATOL = 3e-4  # tests/test_serving_parallel.py's
H = W = 16  # 256 rays -> 32 a shard
CFG = dict(grid_size=16, individual_embedding_num=8, smo_win_size=3, fourier_pos_features=16,
           fourier_amb_features=8, hidden_dim_sigma=32, hidden_dim_ambient=32, hidden_dim_color=32, geo_feat_dim=16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU renders (many small ops), so
    the suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def head():
    """JAX's test model and condition (PRNGKey 0), and the port's model on
    JAX's params."""
    jm = JRADNeRF(JConfig(**CFG))
    key = jax.random.PRNGKey(0)
    cond = jax.random.normal(key, (3, 1, 204))
    params = jax.jit(jm.init)(key, jnp.zeros((8, 3)), jnp.ones((8, 3)), cond)
    tm = TRADNeRF(TConfig(**CFG))
    tm.load_state_dict(convert_flax_params(jax.tree.map(np.asarray, params), tm))
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -2.0
    rays = get_rays(jnp.asarray(pose[None]), (2.0 * W, 2.0 * H, W / 2, H / 2), H, W)
    return dict(jm=jm, params=params, tm=tm.eval(), cond=np.array(cond), ro=np.array(rays["rays_o"][0]),
                rd=np.array(rays["rays_d"][0]))


def _frames(s, occ, opts: dict, head_crop=None):
    """(JAX's single-device frame, the port's frame through
    ShardedFrameRenderer on make_mesh(8, "cpu")), JAX's frame_fn argument
    order."""
    jm = s["jm"]

    def j_frame(head_params, torso_params, sr_params, rays_o, rays_d, cond_win, eye_area, occupancy, bg_color,
                bg_coords, lm68):
        return j_fr.render_full_frame(jm, head_params, rays_o, rays_d, cond_win, occupancy, bg_color=bg_color,
                                      opts=JOptions(num_coarse=16, num_samples=8, **opts), image_hw=(H, W),
                                      eye_area_percent=eye_area, head_crop=head_crop).rgb_map

    def t_frame(head_model, torso_model, sr_model, rays_o, rays_d, cond_win, eye_area, occupancy, bg_color,
                bg_coords, lm68, *, mesh):
        return t_fr.render_full_frame(head_model, rays_o, rays_d, cond_win, occupancy, bg_color,
                                      TOptions(num_coarse=16, num_samples=8, **opts), (H, W),
                                      eye_area_percent=eye_area, head_crop=head_crop, mesh=mesh).rgb_map

    rest = (s["cond"], np.zeros((1, 1), np.float32), occ, np.ones((H * W, 3), np.float32),
            np.array(get_bg_coords(H, W)[0]), np.zeros((1, 68, 2), np.float32))
    single = jax.jit(j_frame)(s["params"], None, None, jnp.asarray(s["ro"]), jnp.asarray(s["rd"]),
                              *(jnp.asarray(a) for a in rest))
    mesh = pm.make_mesh(8, "cpu")
    sharded = ShardedFrameRenderer(t_frame, mesh)(s["tm"], None, None, torch.from_numpy(s["ro"]),
                                                  torch.from_numpy(s["rd"]), *(torch.from_numpy(a) for a in rest))
    return np.asarray(single), sharded.numpy()


def test_sharded_frame_matches_single_device(head):
    single, sharded = _frames(head, np.ones((16, 16, 16), bool), {})
    np.testing.assert_allclose(sharded, single, atol=ATOL)


def _compact_occupancy():
    xx, yy, zz = np.meshgrid(*([np.linspace(-1, 1, 16)] * 3), indexing="ij")
    return (xx ** 2 + (2 * yy) ** 2 + zz ** 2) < 0.3


def test_sharded_frame_with_compaction_and_topk(head):
    """compact_frac 0.9 + color_topk 8 of 8 samples on the sharded frame
    against JAX's exact single-device render (the budget covers the live
    count)."""
    occ = _compact_occupancy()
    single, _ = _frames(head, occ, {})
    _, sharded = _frames(head, occ, {"compact_frac": 0.9, "color_topk": 8})
    np.testing.assert_allclose(sharded, single, atol=ATOL)


def test_sharded_frame_with_head_crop(head):
    """The head crop's offset is taken over all rays on the main device;
    the window's field points are split."""
    single, sharded = _frames(head, _compact_occupancy(), {}, head_crop=(8, 8))
    np.testing.assert_allclose(sharded, single, atol=ATOL)


def test_central_shards_under_a_global_budget(head):
    """A head small in the middle of a 32^2 frame: its 776 live samples of
    8,192 fall in the middle shards' blocks of rays (192 in each of the two
    central ones). The budget of compact_frac 0.125 (1,024 slots) covers
    them all, but its eighth (128) would not cover a central shard's: the
    port ranks and budgets over the whole frame and splits the compact
    buffer, so the sharded frame is the unsharded one, bit for bit, and the
    uncompacted one to 1e-4."""
    from genefaceplusplus_tpu_torch.models.renderer import make_aabb
    from genefaceplusplus_tpu_torch.ops import raymarch
    from genefaceplusplus_tpu_torch.utils.rays import pixel_rays

    n = 32
    xx, yy, zz = np.meshgrid(*([np.linspace(-1, 1, 16)] * 3), indexing="ij")
    occ = torch.from_numpy((xx ** 2 + yy ** 2 + zz ** 2) < 0.06)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -2.0
    ro, rd = (x[0] for x in pixel_rays(torch.from_numpy(pose[None]), (2.0 * n, 2.0 * n, n / 2, n / 2), n, n))
    nears, fars = raymarch.near_far_from_aabb(ro, rd, make_aabb(1.0), 0.05)
    live = raymarch.march_rays_interval(ro, rd, nears, fars, raymarch.occupancy_aabb(occ, 1.0), bound=1.0,
                                        num_samples=8, min_near=0.05, grid_size=16).mask.reshape(-1)
    per_shard = [int(b.sum()) for b in torch.tensor_split(live, 8)]
    M = 1024
    assert int(live.sum()) <= M < n * n * 8 and max(per_shard) > M // 8, per_shard

    def frame(mesh, compact_frac):
        with torch.no_grad():
            return t_fr.render_full_frame(head["tm"], ro, rd, torch.from_numpy(head["cond"]), occ,
                                          torch.ones(n * n, 3), TOptions(num_samples=8, compact_frac=compact_frac),
                                          (n, n), mesh=mesh).rgb_map.numpy()

    sharded = frame(pm.make_mesh(8, "cpu"), M / (n * n * 8))
    np.testing.assert_array_equal(sharded, frame(None, M / (n * n * 8)))
    np.testing.assert_allclose(sharded, frame(None, 0.0), atol=1e-4)


def test_mesh_helpers():
    mesh = pm.make_mesh(8, "cpu")
    assert mesh.size == 8 and mesh.main == torch.device("cpu") and mesh.axis_names == (pm.RAY_AXIS,)
    x = torch.arange(66.0).reshape(33, 2)
    blocks = pm.shard_rays(mesh, x)
    assert len(blocks) == 8 and [b.shape[0] for b in blocks] == [5] + [4] * 7
    torch.testing.assert_close(torch.cat(blocks), x, rtol=0, atol=0)
    xs, ys = pm.shard_rays(mesh, x, x[:, 0])
    assert len(xs) == len(ys) == 8
    model = torch.nn.Linear(2, 3)
    reps = pm.replicated(mesh, model)
    assert all(r is model for r in reps) and pm.replicated(mesh, model) is reps  # made once
    out = pm.map_blocks(mesh, lambda i, a: (reps[i](a), torch.full((a.shape[0],), i)), x)
    torch.testing.assert_close(out[0], model(x))
    assert out[1].tolist() == [0] * 5 + sum(([i] * 4 for i in range(1, 8)), [])
    assert pm.pad_to_multiple(250, 8) == 256
    with pytest.raises(ValueError, match="one type"):
        pm.Mesh(["cpu", "meta"])
    with pytest.raises(ValueError, match="must divide"):
        ShardedFrameRenderer(lambda *a, mesh: None, mesh)(*([None] * 3 + [torch.zeros(250, 3)] * 2 + [None] * 6))
    with pytest.raises(RuntimeError, match="shard 3"):
        pm.map_blocks(mesh, lambda i, a: (_ for _ in ()).throw(RuntimeError(f"shard {i}")) if i == 3 else a, x)


def test_make_mesh_refuses_more_cards_than_exist(monkeypatch):
    """JAX's make_mesh takes fewer devices where fewer exist; the port's
    raises naming both counts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="4 CUDA devices asked for, 2 found"):
        pm.make_mesh(4)
    assert pm.make_mesh(2, "cuda").devices == pm.make_mesh().devices == (torch.device("cuda", 0),
                                                                         torch.device("cuda", 1))


def test_init_distributed_counts_the_job(monkeypatch):
    """Two processes joined over gloo on the CPU each count the job's
    devices (one CPU a process); without an address or the environment the
    rendezvous is skipped and the process counts its own, as JAX's does."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert pm.init_distributed(device="cpu") == 1
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    code = ("import sys, torch.distributed as dist\n"
            "from genefaceplusplus_tpu_torch.parallel.mesh import init_distributed\n"
            f"n = init_distributed('localhost:{port}', 2, int(sys.argv[1]), device='cpu')\n"
            "dist.destroy_process_group()\n"
            "print('devices', n)\n")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(rank)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert all(o.strip().endswith("devices 2") for o in outs), outs


def _wav(seconds: float) -> np.ndarray:
    return (0.3 * np.sin(2 * np.pi * 160 * np.arange(int(16000 * seconds)) / 16000)).astype(np.float32)


def test_stream_infer_multichip_matches_single():
    """stream_infer(mesh=) (B1's plain version on each shard's points): the
    streamed uint8 frames within one level of the unsharded stream's."""
    infer = tiny_infer()
    inp = {"hubert_full": np.random.RandomState(2).randn(2 * 50 + 16, 64).astype(np.float32),
           "blink_mode": "none", "lle_percent": 0.0, "temperature": 0.0}
    single = list(stream_infer(infer, _wav(2.0), dict(inp), chunk_seconds=1.0))
    sharded = list(stream_infer(infer, _wav(2.0), dict(inp), chunk_seconds=1.0, mesh=pm.make_mesh(8, "cpu")))
    assert len(single) == len(sharded) > 0
    for a, b in zip(single, sharded):
        assert np.max(np.abs(a.astype(np.int16) - b.astype(np.int16))) <= 1


def test_chunk_fn_multichip_with_head_crop():
    """A 24^2 identity with a (16, 16) head crop: its frames over an
    8-shard mesh (an instance built with it, so its replicas are made at
    load) within one level of the unsharded instance's, the crop flags
    equal."""
    single, sharded = tiny_infer(24), tiny_infer(24, mesh=pm.make_mesh(8, "cpu"))
    batch = single.prepare_gt_batch([0, 1])
    inp = {"head_crop": [16, 16], "frames_per_dispatch": 2}
    (imgs1, fits1, n1), = single.launch_secc2video(batch, inp)
    (imgs8, fits8, n8), = sharded.launch_secc2video(batch, inp)
    assert n1 == n8 == 2 and fits1 is not None and torch.equal(fits1, fits8)
    assert int((imgs1.to(torch.int16) - imgs8.to(torch.int16)).abs().max()) <= 1
