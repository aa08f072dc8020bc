"""Host milliseconds of the pyramid's capacity planner per request: the
program's ``data.plan_caps`` spans (``utils/cloud.plan_scale_caps``) over
the window.  The benchmark's own ``plan_caps`` span around the same function
names the idle gaps it leaves in the traced run's breakdown."""

from portbench import program

WRAPS = dict(program.ENTRIES,
             plan_caps=("pcr_tpu_torch.utils.cloud", "plan_scale_caps"))


def read(trace):
    snap = program.snapshot()
    if snap is None or not program.has(snap, "data.plan_caps") or trace.work <= 0:
        return None
    return program.host_ms(snap, "data.plan_caps") / trace.work
