"""The port's serve CLI, ``python -m repro_torch.launch.serve``: the
model-free cluster dry-run prints what ``python -m repro.launch.serve``
prints on the same flags, line for line; the real-model replay runs on
``--device cpu``; the flags that map onto the port's attention schedules
(``splitk`` is ``auto``, ``ref`` is refused); and the runner-timing fit
``calibrate`` on the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch.launch.serve as serve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The reduced configs are bf16, whose CPU kernels occupy every core;
    beside other test workers that oversubscribes the machine many times
    over, so the in-process runs here take one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cluster_dry_run_prints_what_jax_prints():
    """Both CLIs run at once, each in its own process."""
    procs = [subprocess.Popen([sys.executable, "-m", module, "--replicas", "2",
                               "--duration", "5"], cwd=ROOT, env=ENV, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for module in ("repro.launch.serve", "repro_torch.launch.serve")]
    try:
        (jout, jerr), (tout, terr) = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert procs[0].returncode == 0, jerr
    assert procs[1].returncode == 0, terr
    assert "online finished:" in tout
    assert tout.splitlines() == jout.splitlines()


def _run_main(monkeypatch, capsys, *flags):
    """``serve.main()`` in this process; returns stdout and the
    ``attn_impl`` each engine was built with."""
    impls = []
    engine_cls = serve.EchoEngine

    def spy(*a, **kw):
        impls.append(kw["attn_impl"])
        return engine_cls(*a, **kw)
    monkeypatch.setattr(serve, "EchoEngine", spy)
    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    serve.main()
    monkeypatch.undo()
    return capsys.readouterr().out, impls


REPLAY = ("--device", "cpu", "--arch", "qwen3-4b", "--duration", "1", "--n-docs", "1",
          "--questions", "2")


def test_replay_on_cpu_finishes_every_online_request(monkeypatch, capsys):
    out, impls = _run_main(monkeypatch, capsys, *REPLAY)
    assert impls == ["auto"]
    line = next(ln for ln in out.splitlines() if ln.startswith("online finished:"))
    done, total = line.split()[2].split("/")
    assert int(total) > 0 and done == total, line
    assert "offline finished: 2/2" in line


def test_attn_impl_splitk_runs_the_auto_schedule(monkeypatch, capsys):
    """The JAX package's accelerator ``auto`` is split-K: ``splitk`` builds
    the engine with the port's ``auto``, and the replay prints the same."""
    auto, _ = _run_main(monkeypatch, capsys, *REPLAY, "--attn-impl", "auto")
    out, impls = _run_main(monkeypatch, capsys, *REPLAY, "--attn-impl", "splitk")
    assert impls == ["auto"]
    assert out == auto


def _exit_code(monkeypatch, capsys, *flags):
    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    with pytest.raises(SystemExit) as exc:
        serve.main()
    out, err = capsys.readouterr()
    return exc.value.code, out, err


def test_attn_impl_ref_is_refused_naming_device_cpu(monkeypatch, capsys):
    rc, out, err = _exit_code(monkeypatch, capsys, "--attn-impl", "ref", "--device", "cpu")
    assert rc == 2
    assert "--device cpu" in err
    assert "online finished" not in out


def test_help_says_kernel_profile_has_no_counterpart(monkeypatch, capsys):
    rc, out, _ = _exit_code(monkeypatch, capsys, "--help")
    assert rc == 0
    assert "--device {cuda,cpu}" in out
    assert "--kernel-profile has no counterpart" in " ".join(out.split())


def test_runner_timing_fit_on_cpu():
    """``calibrate`` fits the Eq. 6-8 prefill and decode terms from timed
    runner calls."""
    cfg = get_config("qwen3-4b").reduced()
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tm = serve.calibrate(model, params, num_blocks=32, device="cpu")
    preset = serve.TimeModel(quadratic_prefill=True)
    assert (tm.c, tm.d0) != (preset.c, preset.d0), "nothing was fitted"
    assert tm.prefill_time([(0, 64)]) >= tm.prefill_time([(0, 16)]) > 0.0
    assert tm.decode_time([1]) > 0.0
