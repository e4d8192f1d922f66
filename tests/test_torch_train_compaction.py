"""Train-side live-sample compaction (`train_compact_start`), port vs JAX on
the CPU: tests/test_train_compaction.py's cases that need no mesh, on the
same synthetic identity, weights, occupancy, batch and noise in both
packages.

Tolerances: a probe's live fraction equal to JAX's to 1e-6 (the same
numpy draws, float32 means); losses rtol 1e-5; gradients of the compacted
step against JAX's compacted step and the port's full-slot step to 1e-3 of
each tensor's largest entry (float32 sums in other orders; JAX holds its
own compacted step to its full-slot step at 5e-3, as here), with the
Fourier scales cut to 16 / 8 as tests/test_torch_train.py does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from genefaceplusplus_tpu.data.dataset import RADNeRFDataset as JDataset
from genefaceplusplus_tpu.models.radnerf import RADNeRFConfig as JConfig
from genefaceplusplus_tpu.training import radnerf_task as j_task
from genefaceplusplus_tpu.training.tasks.head_task import HeadNeRFTask as JTask
from genefaceplusplus_tpu.training.tasks.head_task import HeadTaskConfig as JTaskCfg
from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset as TDataset
from genefaceplusplus_tpu_torch.data.dataset import synthetic
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRF as TRADNeRF
from genefaceplusplus_tpu_torch.models.radnerf import RADNeRFConfig as TConfig
from genefaceplusplus_tpu_torch.training import radnerf_task as t_task
from genefaceplusplus_tpu_torch.training.tasks.head_task import HeadNeRFTask, HeadTaskConfig
from genefaceplusplus_tpu_torch.utils.convert_jax import convert_flax_params

HW = 24
SMALL = dict(grid_size=16, individual_embedding_num=16, smo_win_size=3, fourier_pos_features=16,
             fourier_amb_features=8, hidden_dim_sigma=32, hidden_dim_ambient=32, hidden_dim_color=32,
             geo_feat_dim=16, fourier_pos_max_scale=16.0, fourier_amb_max_scale=8.0)
TASK = dict(n_rays=256, num_coarse=16, num_samples=8, lr=5e-3)
AMBIENT_PATH = ("cond_prenet", "blink_", "cond_att_net", "position_embedder", "ambient_", "sigma_net.dense.0")


def _blob_occupancy(g=16, r2=0.16):
    xx, yy, zz = np.meshgrid(*([np.linspace(-1, 1, g)] * 3), indexing="ij")
    return (xx ** 2 + (2.0 * yy) ** 2 + zz ** 2) < r2


def _port_task(widths=SMALL, **cfg_kw):
    ds = TDataset(synthetic(num_frames=12, H=HW, W=HW), smo_win_size=3, with_sr=False)
    task = HeadNeRFTask(ds, TConfig(**widths), HeadTaskConfig(**TASK, **cfg_kw),
                        t_task.TaskHParams(ambient_ramp_total=100), device="cpu")
    task.occupancy = torch.from_numpy(_blob_occupancy())
    return task


def _jax_task(**cfg_kw):
    from genefaceplusplus_tpu.data.dataset import synthetic as j_synthetic

    ds = JDataset(j_synthetic(num_frames=12, H=HW, W=HW), split="train", smo_win_size=3, with_sr=False)
    task = JTask(ds, JConfig(**SMALL), JTaskCfg(**TASK, **cfg_kw), j_task.TaskHParams(ambient_ramp_total=100))
    task.occupancy = jnp.asarray(_blob_occupancy())
    return task


def _grads_close(g_t, g_ref, rel, what):
    bad = []
    for name, g in g_t.items():
        a, b = g.double().numpy(), g_ref[name].double().numpy()
        scale = max(np.abs(a).max(), np.abs(b).max(), 1e-8)
        if np.abs(a - b).max() > rel * scale + 5e-7:
            bad.append((name, np.abs(a - b).max() / scale))
    assert not bad, (what, bad)


def test_compacted_step_matches_full_slot_and_jax():
    """The probe's fraction equals JAX's (same draws); with a covering budget
    the compacted step's loss and gradients equal the full-slot step's and
    JAX's compacted step's. The batch's ray 0 is the frame's centre pixel,
    whose first sample is live, and the budget has pad slots: the pad slots'
    duplicate writes of slot 0 reach the gradient once."""
    task_t, task_j = _port_task(), _jax_task()
    frac = task_t._live_frac_probe(n_probes=4)
    assert abs(frac - task_j._live_frac_probe(n_probes=4)) <= 1e-6
    budget = min(0.99, 2.0 * frac + 0.05)
    assert budget < 0.99, f"blob occupancy too dense for the test (live={frac})"

    b = task_t.sample_train_batch()
    b_j = task_j.sample_train_batch()
    np.testing.assert_array_equal(b["inds"], b_j["inds"])
    inds = b["inds"].copy()
    inds[0] = (HW // 2) * HW + HW // 2
    gathered = task_t._make_ray_gather()(task_t._device_frames(), torch.tensor(b["frame_idx"]),
                                         torch.from_numpy(inds).long())
    batch_j = task_j._make_ray_gather()(task_j._device_frames(), jnp.asarray(b["frame_idx"], jnp.int32),
                                        jnp.asarray(inds))
    noise = np.random.RandomState(3).rand(TASK["n_rays"]).astype(np.float32)
    opts_c = dataclasses.replace(task_t.opts, compact_frac=budget)

    from genefaceplusplus_tpu_torch.models.renderer import make_aabb
    from genefaceplusplus_tpu_torch.ops import raymarch

    ro, rd = gathered["rays_o"], gathered["rays_d"]
    nears, fars = raymarch.near_far_from_aabb(ro, rd, make_aabb(1.0), task_t.cfg.min_near)
    mask = raymarch.march_rays_interval(ro, rd, nears, fars, raymarch.occupancy_aabb(task_t.occupancy, 1.0),
                                        num_samples=8, noise=torch.from_numpy(noise), min_near=task_t.cfg.min_near,
                                        grid_size=16).mask
    N = mask.numel()
    assert bool(mask[0, 0]) and int(mask.sum()) < min(N, ((int(budget * N) + 511) // 512) * 512)

    state_j = task_j.create_state()
    model = TRADNeRF(task_t.cfg)
    model.load_state_dict(convert_flax_params(jax.tree.map(np.asarray, state_j.params), model))
    lam = torch.tensor(1.0)

    def port(opts):
        model.zero_grad()
        total, m = t_task.head_loss_fn(model, gathered, task_t.occupancy, opts, task_t.hp, 0, lam,
                                       torch.from_numpy(noise))
        total.backward()
        return float(total), {k: p.grad.detach().clone() for k, p in model.named_parameters()}

    def jax_(opts):
        def f(params):
            return j_task.head_loss_fn(params, task_j.model, batch_j, task_j.occupancy, opts, task_j.hp,
                                       state_j.global_step, state_j.lambda_ambient, jnp.asarray(noise))
        (loss, _), g = jax.jit(jax.value_and_grad(f, has_aux=True))(state_j.params)
        return float(loss), convert_flax_params(jax.tree.map(np.asarray, g), model)

    l_full, g_full = port(task_t.opts)
    l_comp, g_comp = port(opts_c)
    l_jfull, g_jfull = jax_(task_j.opts)
    l_j, g_j = jax_(dataclasses.replace(task_j.opts, compact_frac=budget))
    np.testing.assert_allclose(l_comp, l_full, rtol=1e-5)
    np.testing.assert_allclose(l_comp, l_j, rtol=1e-5)
    _grads_close(g_comp, g_full, 1e-3, "full-slot")
    _grads_close(g_j, g_jfull, 5e-3, "jax's own full-slot")
    # on this batch jitted XLA's gradients of the ambient path (the ambient,
    # condition and blink nets, both Fourier B's, the sigma net's first
    # layer) sit up to 15 % of a tensor's largest entry from eager JAX's, in
    # the full-slot step as in the compacted one, while the port's equal
    # eager JAX's to 1e-4 of it: so there the port's compacted step is held
    # to JAX's through the same difference in both steps
    _grads_close({k: g_comp[k] - g_j[k] for k in g_comp}, {k: g_full[k] - g_jfull[k] for k in g_full}, 1e-3,
                 "jax, compacted minus full-slot")
    exact = [k for k in g_comp if not k.startswith(AMBIENT_PATH)]
    _grads_close({k: g_comp[k] for k in exact}, g_j, 1e-3, "jax")


def test_fused_compacted_step_matches_full_slot():
    """use_fused_field on a compacted budget (B1's train mode and B2 on M
    points; their plain versions on the CPU) against the fused full-slot
    step: M = 512 is no multiple of any kernel tile's point count but 512.
    Losses rtol 1e-5; gradients 2^-7 of each tensor's largest entry (the
    fused VJP casts its float32 gradient blocks to the weights' bf16, where
    a sum in another order can flip one rounding: one bf16 step, 2^-8 to
    2^-7 of the entry)."""
    task = _port_task(widths=dict(grid_size=16, individual_embedding_num=16, smo_win_size=3,
                                  fourier_pos_max_scale=16.0, fourier_amb_max_scale=8.0), use_fused_field=True)
    b = task.sample_train_batch()
    gathered = task._make_ray_gather()(task._device_frames(), torch.tensor(b["frame_idx"]),
                                       torch.from_numpy(b["inds"]).long())
    noise = torch.from_numpy(np.random.RandomState(4).rand(TASK["n_rays"]).astype(np.float32))
    model = TRADNeRF(task.cfg, generator=torch.Generator().manual_seed(0))
    lam = torch.tensor(1.0)
    out = {}
    for cf in (0.0, 0.25):
        model.zero_grad()
        total, _ = t_task.head_loss_fn(model, gathered, task.occupancy, dataclasses.replace(task.opts, compact_frac=cf),
                                       task.hp, 0, lam, noise, use_fused_field=True)
        total.backward()
        out[cf] = (float(total), {k: p.grad.detach().clone() for k, p in model.named_parameters()})
    np.testing.assert_allclose(out[0.25][0], out[0.0][0], rtol=1e-5)
    _grads_close(out[0.25][1], out[0.0][1], 2.0 ** -7, "fused")


def test_task_switches_at_compact_start():
    """train_step switches to the compacted step at train_compact_start,
    probing with JAX's draws (its fraction equals JAX's probe after the
    same three batches), reports the budget as telemetry, and each grid
    refresh probes again."""
    task = _port_task(train_compact_start=2, train_compact_margin=1.5)
    state = task.create_state()
    metrics = {}
    for _ in range(3):
        state, metrics = task.train_step(state, task.sample_train_batch())
    assert task._compact_step is not None and task._compact_step is not task._train_step
    assert 0.0 < metrics["compact/budget_frac"] < 0.85
    assert np.isfinite(float(metrics["total_loss"]))
    task_j = _jax_task(train_compact_start=2, train_compact_margin=1.5)
    for _ in range(3):
        task_j.sample_train_batch()
    assert abs(metrics["compact/probe_live_frac"] - task_j._live_frac_probe()) <= 1e-6
    task.update_extra_state(state)
    assert "compact/probe_live_frac" in task._compact_telemetry
    # a resume keeps the budget without probing again (an exact resume)
    host = task.host_state()
    again = _port_task(train_compact_start=2, train_compact_margin=1.5)
    again.load_host_state(host)
    assert again._compact_telemetry == task._compact_telemetry and again._compact_step is not None
    assert again.np_rng.randint(1 << 30) == task.np_rng.randint(1 << 30)


def test_sr_task_switches_to_compacted_step():
    """The SR task switches too: full-frame batches, so the live fraction is
    the head's screen coverage."""
    from genefaceplusplus_tpu_torch.training.tasks.sr_task import SRHeadNeRFTask, SRTaskConfig

    ds = TDataset(synthetic(num_frames=8, H=16, W=16), smo_win_size=3, with_sr=True)
    tcfg = SRTaskConfig(n_rays=256, num_coarse=8, num_samples=4, lr=1e-3, sr_start_iters=0,
                        lpips_start_iters=10_000, train_compact_start=2, train_compact_margin=1.2)
    task = SRHeadNeRFTask(ds, TConfig(**SMALL), tcfg, t_task.TaskHParams(), device="cpu")
    task.occupancy = torch.from_numpy(_blob_occupancy(r2=0.06))
    state = task.create_state()
    metrics = {}
    for _ in range(3):
        state, metrics = task.train_step(state, task.sample_train_batch())
    assert task._compact_step is not None and task._compact_step is not task._train_step
    assert 0.0 < metrics["compact/budget_frac"] < 0.85
    assert np.isfinite(float(metrics["total_loss"])) and np.isfinite(float(metrics["sr_mse_loss"]))
    task.update_extra_state(state)
    assert "compact/probe_live_frac" in task._compact_telemetry


def test_dense_grid_aliases_to_full_slot():
    """Where the live fraction leaves no headroom (budget >= 85 %), the
    switch keeps the full-slot step."""
    task = _port_task(train_compact_start=1, train_compact_margin=1.35)
    task._live_frac_probe = lambda n_probes=8: 0.9
    task._enable_train_compaction()
    assert task._compact_step is task._train_step
    assert task._compact_telemetry["compact/budget_frac"] >= 0.85
