"""Where the time of one head-NeRF train step goes, on the card.

Builds the train phase of chip_smoke.py (the May lm3d_radnerf head config at
full width, random weights from a seed, a synthetic 512^2 identity, 65,536
rays x 16 samples, use_fused_field=True), refreshes the occupancy grid
once, runs WARMUP steps, then profiles STEPS steps with torch.profiler and
prints the device time of each kernel (per step, largest first), the
step's host wall time and the device's busy share (the sum of kernel times
over the wall time: kernels run on one stream). The wall time is taken
under the profiler, which adds host time to every launch.

    python -m genefaceplusplus_tpu_torch.tools.profile_train_step
"""

import subprocess
import time

import torch

WARMUP, STEPS, TOP = 5, 5, 24


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step: needs a CUDA device")
    from genefaceplusplus_tpu_torch.data.dataset import RADNeRFDataset, synthetic
    from genefaceplusplus_tpu_torch.models.radnerf import MAY_LM3D_RADNERF, RADNeRFConfig
    from genefaceplusplus_tpu_torch.training.tasks.head_task import HeadNeRFTask, HeadTaskConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = RADNeRFConfig.from_hparams(MAY_LM3D_RADNERF)
    ds = RADNeRFDataset(synthetic(num_frames=24, H=512, W=512, seed=0), smo_win_size=cfg.smo_win_size)
    task = HeadNeRFTask(ds, cfg, HeadTaskConfig(n_rays=65536, num_samples=16, lr=5e-4, use_fused_field=True),
                        seed=9999, device=dev)
    state = task.create_state()
    task.update_extra_state(state)

    def step(state):
        state, metrics = task.train_step(state, task.sample_train_batch(state.global_step))
        return state

    for _ in range(WARMUP):
        state = step(state)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state = step(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    # kernels and copies; the optimizer's annotation ("Optimizer.step#Adam.step")
    # is a range on the device timeline that holds kernels already counted
    kernels = [e for e in prof.key_averages() if device_us(e) > 0 and not e.key.startswith("Optimizer.")
               and e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in kernels) / 1e3 / STEPS
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[profile] {card}; {STEPS} steps after {WARMUP} warm-up")
    print(f"[profile] step wall {wall_ms:.3f} ms (under the profiler); device busy {busy_ms:.3f} ms "
          f"({100.0 * busy_ms / wall_ms:.1f} %); {len(kernels)} kernel names")
    for e in kernels[:TOP]:
        ms = device_us(e) / 1e3 / STEPS
        print(f"[profile] {ms:9.4f} ms/step {100.0 * ms / busy_ms:5.1f} %  x{e.count // STEPS:<4d} {e.key[:110]}")


if __name__ == "__main__":
    main()
