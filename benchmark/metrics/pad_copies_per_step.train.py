"""Padded copies a training step: systems that are not whole 128-row
panels copied into a padded buffer before their blocked factor (the
port's ``ops.linalg.LAUNCHES["pad"]``, read as ``launches.pad``, a
graph replay's counted as the eager pass's).  0 where nothing was
padded; nothing where the run has no steps or the program has no such
counter."""


def read(run):
    if not run.steps or "launches.pad" not in run.counters:
        return None
    return run.counted("launches.pad") / run.steps
