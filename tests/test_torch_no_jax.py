"""The PyTorch port never imports JAX: in a fresh interpreter where
`import jax` fails, import ecw_cc_torch, build its solver on H2/6-31G
through the ECW driver and run one solve."""

import os
import subprocess
import sys
import textwrap

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now raises
    import torch
    torch.set_num_threads(1)
    import ecw_cc_torch
    from ecw_cc_torch import ECW
    ecw = ECW("H 0 0 0\\nH 0 0 1", "6-31g", device="cpu",
              dtype=torch.float64)
    ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
    res = ecw.CCSD_GS([0.5], diis="tl", conv_thres=1e-8)
    assert "Convergence reached" in res[0], res[0]
    assert ecw.solve_log[0]["sym"]
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "jaxlib")))
    assert sys.modules["jax"] is None and bad == ["jax"], bad
    print("NO_JAX_OK", res[1][-1])
""")


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout
