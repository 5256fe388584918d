"""What the benchmark loads, by top-level module name (the part before the
first dot), each in a fresh interpreter: nothing of JAX or of the JAX
package anywhere in the harness, its traffic and metric readers and the
system they drive; nothing of the system in the reference."""

import json
import os
import subprocess
import sys

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
JAX_SIDE = {"jax", "jaxlib", "flax", "pillarnet_lts_tpu"}


def _top_level_after(code):
    """The top-level names in sys.modules after running `code`."""
    prog = (f"import sys\nsys.path.insert(0, {CHECKOUT!r})\n{code}\n"
            "import json\nprint(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, cwd=CHECKOUT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_system_load_no_jax():
    names = _top_level_after(
        "import benchmark.run\n"
        "from benchmark.harness import session, program\n"
        "session.metric_readers()\n"
        "import benchmark.tools.readings\n"
        "import pillarnet_lts_torch.eval_utils, pillarnet_lts_torch.models\n"
        "import pillarnet_lts_torch.runtime.serving\n"
        "import pillarnet_lts_torch.runtime.quantize\n")
    assert "pillarnet_lts_torch" in names and "benchmark" in names
    assert not names & JAX_SIDE, names & JAX_SIDE


def test_reference_loads_nothing_of_the_system():
    names = _top_level_after("import benchmark.reference.model\n"
                             "import benchmark.reference.boxes\n"
                             "import benchmark.counts\n")
    assert "benchmark" in names
    assert not names & (JAX_SIDE | {"pillarnet_lts_torch"})


def test_run_refuses_without_a_card():
    """Without CUDA, or with fewer devices than the cell asks for, a run
    exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "nusc_f32_stream",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=CHECKOUT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
