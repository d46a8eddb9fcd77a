"""What the benchmark loads: the harness never JAX or the JAX package
(nor the repository's JAX tools), the reference nothing of the port."""
import subprocess
import sys

from benchmark.harness import spec

HARNESS = """
import sys
import benchmark.run, benchmark.harness.check, benchmark.harness.timeline
import benchmark.harness.readers, benchmark.harness.program
from benchmark.harness import spec
import benchmark.reference.lcp, benchmark.reference.world
import benchmark.reference.train, benchmark.reference.joints
for folder in ("loops", "scenes", "shapes", "metrics"):
    for path in sorted((spec.HERE / folder).glob("*.py")):
        spec.plugin(folder, path.stem)
bench = spec.load_json(spec.BENCHMARK)
for w in bench["workloads"]:
    spec.cell(w["name"])
print(sorted({m.split(".")[0] for m in sys.modules}))
"""

REFERENCE = """
import importlib, pathlib, sys
import benchmark.reference.lcp, benchmark.reference.world
import benchmark.reference.train, benchmark.reference.joints
here = pathlib.Path(benchmark.reference.__file__).parent / "shapes"
for path in sorted(here.glob("*.py")):
    importlib.import_module("benchmark.reference.shapes." + path.stem)
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def _top_levels(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    tops = _top_levels(HARNESS)
    assert "lcp_physics_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "lcp_physics_tpu", "tools"}


def test_reference_loads_nothing_of_the_program():
    tops = _top_levels(REFERENCE)
    assert not tops & {"jax", "jaxlib", "flax", "lcp_physics_tpu", "tools",
                       "lcp_physics_tpu_torch"}
    ours = _top_levels(REFERENCE.replace(
        "m.split(\".\")[0] for m in sys.modules",
        "m for m in sys.modules if m.startswith(\"benchmark\")"))
    assert {"benchmark.reference.lcp", "benchmark.reference.joints",
            "benchmark.reference.shapes.circle"} <= ours
    assert not [m for m in ours if m.startswith("benchmark.harness")]
