"""Device time per step from a profiler trace (resuneta_tpu/utils/xprof.py).

A step's wall time on the host's clock holds the host's work and its
waits; the card's kernel time does not. `capture_device_ms` runs a step
under torch.profiler and sums the durations of the device's kernels, the
counterpart of the reference's sum over the TPU plane's 'XLA Ops' line.

It returns None only where the profile holds no device event (a CPU run,
as the reference returns None without a TPU plane). A failure of the
profiler or of the step raises: the reference's `except Exception: return
None` (xprof.py:62-70) would hide a failure on the card.
"""

import torch


def op_times_ms(prof):
    """{kernel name: ms} summed over the device (CUDA) events of a
    torch.profiler profile; {} where it holds none. Device-side user
    ranges ("Optimizer.step#Adam.step") span kernels already counted, so
    only kernels count."""
    times = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                "#" not in ev.name:
            times[ev.name] = times.get(ev.name, 0.0) + \
                ev.device_time_total / 1e3
    return times


def device_ms_per_step(prof, n_steps):
    """The kernels' total ms over the profile divided by the steps it
    captured; None where it holds no device event."""
    times = op_times_ms(prof)
    return sum(times.values()) / n_steps if times else None


def capture_device_ms(step_thunk, n_steps, sync):
    """Run `step_thunk()` n_steps times under torch.profiler (the CPU and,
    where there is one, the card) and return the device ms a step (None
    without device events). `sync()` must block until the submitted work
    is done."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(n_steps):
            step_thunk()
        sync()
    return device_ms_per_step(prof, n_steps)
