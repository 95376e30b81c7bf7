"""launches.<mix>: the program's launch counters (every `*launches` count on
a function of sipp_tpu_torch's modules, the wrappers' own), summed over the
traced operations, per operation."""


def read(run):
    t = run.trace
    if t is None or not t.ops or not t.counters:
        return None
    return sum(t.counters.values()) / len(t.ops)
