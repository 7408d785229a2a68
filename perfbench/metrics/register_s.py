"""register_s: host clock around ``SpmvServingEngine.register`` (plan
resolution, the schedule built or reloaded through the PlanCache, the
bind to the card); the schedule spans are printed on an earlier line."""


def read(run):
    return run.register_s if run.register_s > 0 else None
