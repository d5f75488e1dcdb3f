"""PyTorch port: runner (options -> engine structures, YAML loading, CLI)
and the batch entry point vs the JAX package."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbd_nmpc_tpu.nmpc import runner as jrunner
from srbd_nmpc_tpu.utils import config as jconfig
from srbd_nmpc_tpu_torch.nmpc import engine, runner
from srbd_nmpc_tpu_torch.parallel import sharded
from srbd_nmpc_tpu_torch.utils import config

torch.set_num_threads(1)

YAML = """\
MPC:
  Q: [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 10]
  Qf: [0.5, 0.5, 0.5, 0.01, 0.01, 0.01, 100, 100, 100, 0, 0, 100]
  R: 0.0001
  dt_MPC: 0.015
  horizon_MPC: 5
  sqp_max_loop: 15
Physical:
  Lbody: [0.541667, 0.516667, 1.0416667]
mu_b: 0.1
theta_b: 5.0
N_rep: 3
"""


def test_default_options_match_jax():
    assert dataclasses.asdict(config.MpcOptions.default()) == \
        dataclasses.asdict(jconfig.MpcOptions.default())


def test_build_from_options_matches_jax_field_by_field():
    opts = config.MpcOptions.default()
    p, w, cfg = runner.build_from_options(opts, torch.float64, device="cpu")
    p_j, w_j, cfg_j = jrunner.build_from_options(
        jconfig.MpcOptions.default(), jnp.float64)
    for f in dataclasses.fields(cfg_j):
        assert getattr(cfg, f.name) == getattr(cfg_j, f.name), f.name
    for obj, obj_j in ((p, p_j), (w, w_j)):
        for f in dataclasses.fields(obj_j):
            np.testing.assert_array_equal(
                getattr(obj, f.name).numpy(),
                np.asarray(getattr(obj_j, f.name)), err_msg=f.name)


def test_load_mpc_options_parses_yaml(tmp_path):
    path = tmp_path / "mpc_option.yaml"
    path.write_text(YAML)
    opts = config.load_mpc_options(str(path))
    assert dataclasses.asdict(opts) == dataclasses.asdict(
        jconfig.load_mpc_options(str(path)))
    assert opts.horizon == 5 and opts.n_rep == 3
    bad = tmp_path / "bad.yaml"
    bad.write_text(YAML.replace("theta_b: 5.0\n", ""))
    with pytest.raises(KeyError, match="theta_b"):
        config.load_mpc_options(str(bad))


def test_cli_runs_and_converges(tmp_path, capsys):
    path = tmp_path / "mpc_option.yaml"
    path.write_text(YAML)
    runner.main(["--config", str(path), "--batch", "4", "--nrep", "1",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "(converged: 4/4)" in out
    assert "Device: " in out


def test_entry_points_default_to_the_card(tmp_path, capsys):
    """Without a card the default device raises at every entry point (no
    CPU fallback); ``device="cpu"`` / ``--device cpu`` run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    opts = config.MpcOptions.default()
    with pytest.raises(RuntimeError, match="cuda"):
        runner.build_from_options(opts)
    with pytest.raises(RuntimeError, match="cuda"):
        runner.run_control_loop(opts, nrep=1)
    for make in (lambda: engine.NmpcWeights.create([1.0] * 12, 1e-4,
                                                   [1.0] * 12, 5),
                 lambda: engine.NmpcState.initial(5),
                 lambda: engine.make_benchmark_problem(engine.NmpcConfig(N=5))):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    p, w, _ = runner.build_from_options(opts, device="cpu")
    assert p.mass.device.type == w.Q.device.type == "cpu"
    path = tmp_path / "mpc_option.yaml"
    path.write_text(YAML)
    with pytest.raises(RuntimeError, match="cuda"):
        runner.main(["--config", str(path), "--batch", "2", "--nrep", "1"])
    runner.main(["--config", str(path), "--batch", "2", "--nrep", "1",
                 "--device", "cpu"])
    assert "Device: cpu" in capsys.readouterr().out


def test_solve_batch_summary():
    opts = config.MpcOptions.default()
    params, weights, cfg = runner.build_from_options(
        dataclasses.replace(opts, horizon=5), torch.float64, device="cpu")
    x0, x_ref = engine.make_benchmark_problem(cfg, torch.float64, device="cpu")
    states = sharded.broadcast_state(
        engine.NmpcState.initial(cfg.N, torch.float64, device="cpu"), 3)
    assert states.x.shape == (3, 6, 12) and states.alpha.shape == (3,)
    st, info, s = sharded.solve_batch(params, weights, cfg, states,
                                      x0.expand(3, 12), x_ref)
    assert int(s.n_converged) == int(info.converged.sum()) == 3
    assert float(s.mean_iters) == pytest.approx(
        float(info.sqp_iters.double().mean()))
    assert float(s.max_theta) == float(info.theta.max())
    assert st.u.shape == (3, 5, 12)
