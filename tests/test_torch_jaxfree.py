"""The port runs where JAX cannot be imported (the card's machine has no
JAX): a subprocess blocks every `jax` import with a meta-path finder,
imports `circuits_tpu_torch` and its host door, builds the suite's
(3, 16, 2, 2) batches with the shared builder, runs `RollupEngine.run` on
the CPU, holds the outputs against the builder, runs both plain versions of
the full-round experiment against its bigint mirror, and checks that `jax`
never entered `sys.modules`."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, BlockJax())
    sys.path[:0] = sys.argv[1:3]  # the repository root, tests/

    import circuits_tpu_torch  # noqa: F401
    import circuits_tpu_torch.host  # noqa: F401
    from circuits_tpu_torch.engine.witness import RollupEngine
    from circuits_tpu_torch.field import fr
    from circuits_tpu_torch.ops import poseidon_rounds
    from circuits_tpu_torch.scripts import exp_mxu_inkernel
    from torch_compare import SUITE_CONFIG, oracle_outputs, suite_batches

    engine = RollupEngine(*SUITE_CONFIG, device="cpu")
    for name, bb in suite_batches().items():
        out, ok = engine.run(bb.get_input())
        want = oracle_outputs(bb)
        assert ok, name
        assert {k: out[k] for k in want} == want, name
    state, vals = exp_mxu_inkernel.random_state(6)
    vpu = poseidon_rounds.full_rounds_vpu_plain(state, 2)
    assert bool((vpu == poseidon_rounds.full_rounds_mxu_plain(state, 2)).all())
    got = fr.unpack_np(vpu)
    for lane in range(6):
        assert [int(got[e, lane]) for e in range(3)] == \
            poseidon_rounds.full_rounds_py([v[lane] for v in vals], 2), lane
    assert not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                   for m in sys.modules), "jax was imported"
    print("JAX-FREE OK")
""")


def test_port_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", SCRIPT, ROOT,
                          os.path.join(ROOT, "tests")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "JAX-FREE OK" in res.stdout
