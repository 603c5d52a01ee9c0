"""Neither JAX nor the JAX package in a run; nothing of the program in the
reference."""

import subprocess
import sys

import pytest

from rxbench import isolation, spec


@pytest.mark.parametrize("names, bad", [
    (["liquiddsp_tpu_torch", "liquiddsp_tpu_torch.phy.framesync", "torch"], []),
    (["liquiddsp_tpu.phy"], ["liquiddsp_tpu.phy"]),
    (["liquiddsp_tpu"], ["liquiddsp_tpu"]),
    (["jax", "jax.numpy", "jaxlib.xla_client", "flax"], ["flax", "jax", "jax.numpy", "jaxlib.xla_client"]),
    (["jaxtyping", "flaxen", "liquiddsp_tpu_x"], []),
])
def test_top_level_names_compared_whole(names, bad):
    assert isolation.found(names) == bad
    if bad:
        with pytest.raises(isolation.Loaded):
            isolation.check("here", names)
    else:
        isolation.check("here", names)


def _loaded_after(imports: str) -> set[str]:
    code = f"import sys; {imports}; print('\\n'.join(sorted(sys.modules)))"
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return {m.split(".", 1)[0] for m in out.stdout.split()}


def test_the_reference_imports_nothing_of_the_program():
    tops = _loaded_after("import rxbench.reference, rxbench.tx, rxbench.windows, rxbench.compare, "
                         "rxbench.frame, rxbench.work, rxbench.trace")
    assert not tops & {"liquiddsp_tpu_torch", "liquiddsp_tpu", "jax", "jaxlib", "flax"}


def test_a_run_loads_no_jax():
    """The harness, every metric reader and every entry's receiver with the
    program it builds load neither JAX nor the JAX package."""
    imports = ("import rxbench.run, rxbench.control, torch; from rxbench import spec; "
               "[spec.load_cell(w) for w in ('v27golay.chunks', 'uncoded.chunks', "
               "'v27golay.push4096', 'v27golay.sharded8')]; "
               "import liquiddsp_tpu_torch.runtime.stream, "
               "liquiddsp_tpu_torch.runtime.distributed_stream, liquiddsp_tpu_torch.parallel.mesh")
    tops = _loaded_after(imports)
    assert "liquiddsp_tpu_torch" in tops
    assert not tops & {"liquiddsp_tpu", "jax", "jaxlib", "flax"}
