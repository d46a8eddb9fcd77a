"""Share (%) of a training step's unfused IPM passes (solver.iter spans)
that ran as a replay of the pass's CUDA graph (a solver.graph span inside
each); None where the program opens no solver.graph span."""
from benchmark.harness.spans import span_count


def read(run):
    graphed = span_count(run, "solver.graph")
    passes = span_count(run, "solver.iter")
    if graphed is None or passes is None:
        return None
    return 100.0 * graphed / passes
