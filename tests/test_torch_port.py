"""Hygiene of the PyTorch port: it stands alone (no jax, nothing of the JAX
package), its entry points never fall back to the CPU, and a CUDA tensor
reaches a kernel or raises — never the plain version."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import chunked_prefill as cp_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa_mod  # noqa: E402
from repro_torch.kernels import rglru_scan as rglru_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names():
    names = []
    for f in sorted(PORT.rglob("*.py")):
        rel = f.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        names.append(".".join(parts))
    return names


def test_port_modules_import_without_jax_or_repro():
    """(a) Every module of the port, and chip_smoke, imports with jax made
    unimportable, and no module of the JAX package gets loaded."""
    code = f"""
import importlib, sys
sys.modules["jax"] = None
sys.path[:0] = [{str(ROOT / "src")!r}, {str(ROOT)!r}]
for name in {_module_names()!r} + ["chip_smoke"]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro.")
             or m == "jax" and sys.modules[m] is not None or m.startswith("jax."))
assert not bad, bad
print("ok", len({_module_names()!r}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {m}"


def _tiny():
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import Model
    cfg = ModelConfig(name="tiny-dense", family="dense", source="test",
                      num_layers=2, d_model=64, vocab_size=128, num_heads=4,
                      num_kv_heads=2, head_dim=16, d_ff=128, dtype="float32")
    m = Model(cfg)
    return m, m.init(torch.Generator().manual_seed(0))


def test_default_device_without_card_raises():
    """(b) On a machine without a card, the engine and the runner built
    with their default device raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.core import ECHO, EchoEngine
    from repro_torch.models.paged import TorchPagedRunner
    model, params = _tiny()
    with pytest.raises(RuntimeError, match="cuda"):
        EchoEngine(model, params, ECHO, num_blocks=16, block_size=8)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchPagedRunner(model, params, 16, 8, 4, 16)
    eng = EchoEngine(model, params, ECHO, num_blocks=16, block_size=8,
                     device="cpu")
    assert eng.runner.device.type == "cpu"


@pytest.fixture
def fake_cuda():
    """CUDA tensors without a card: fake tensors carry the device but no
    storage, enough to drive the dispatch up to the kernel launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        yield mode


@pytest.fixture
def no_plain(monkeypatch):
    """Replace the plain versions in the kernel modules with tripwires."""
    calls = []

    def trip(*a, **k):
        calls.append(a)
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(pa_mod, "ref_paged_attention", trip)
    monkeypatch.setattr(cp_mod, "ref_chunked_prefill_attention", trip)
    monkeypatch.setattr(ssd_mod, "ssd_chunked", trip)
    monkeypatch.setattr(rglru_mod, "ref_rglru_scan", trip)
    monkeypatch.setattr(ssd_mod, "ssd_chunked_bwd", trip)
    monkeypatch.setattr(rglru_mod, "ref_rglru_scan_bwd", trip)
    return calls


@pytest.fixture
def no_toolchain(monkeypatch, tmp_path):
    """A build without nvcc, whatever this machine has."""
    from repro_torch.kernels import build

    def missing():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(build, "_nvcc", missing)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_fns", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")


def test_cuda_tensor_without_kernel_raises(fake_cuda, no_plain, no_toolchain):
    """(c) Given CUDA tensors and no kernel, the dispatch raises: it never
    calls the plain version."""
    q = torch.empty((2, 8, 32), device="cuda")
    kp = torch.empty((6, 8, 2, 32), device="cuda")
    bt = torch.zeros((2, 3), dtype=torch.int32, device="cuda")
    cl = torch.ones((2,), dtype=torch.int32, device="cuda")
    for impl in ("auto", "pallas"):
        with pytest.raises(RuntimeError, match="nvcc"):
            ops.paged_attention(q, kp, kp, bt, cl, impl=impl)
    k = torch.empty((24, 2, 32), device="cuda")
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.chunked_prefill_attention(q, k, k, 3)
    x = torch.empty((1, 64, 4, 16), device="cuda")
    dta = torch.empty((1, 64, 4), device="cuda")
    bm = torch.empty((1, 64, 8), device="cuda")
    init = torch.empty((1, 4, 16, 8), device="cuda")
    for kw in ({}, dict(initial_state=init, return_all_states=True)):
        with pytest.raises(RuntimeError, match="nvcc"):
            ops.ssd_scan(x, dta, bm, bm, chunk=16, **kw)
    for s in (37, 3072):
        a = torch.empty((1, s, 64), device="cuda")
        with pytest.raises(RuntimeError, match="nvcc"):
            ops.rglru_scan(a, a)
    assert no_plain == []


def test_cuda_tensor_with_grad_reaches_the_backward_kernels(fake_cuda, no_plain,
                                                           no_toolchain, monkeypatch):
    """(c) With a gradient wanted, CUDA tensors go through the scans'
    Functions: their forwards to the forward kernels, their backwards to
    the backward kernels, never to a plain version. The Functions' forward
    and backward are called as autograd calls them (``apply`` on a CUDA
    tensor, and the engine, would reach for a card)."""
    import types
    entered = []

    def direct(fn):
        def apply(*args):
            entered.append(fn.__name__)
            ctx = types.SimpleNamespace(save_for_backward=lambda *t: None)
            return fn.forward(ctx, *args)
        return apply
    monkeypatch.setattr(ssd_mod.SsdScanFn, "apply", direct(ssd_mod.SsdScanFn))
    monkeypatch.setattr(rglru_mod.RglruScanFn, "apply", direct(rglru_mod.RglruScanFn))
    x = torch.empty((1, 64, 4, 16), device="cuda", requires_grad=True)
    dta = torch.empty((1, 64, 4), device="cuda")
    bm = torch.empty((1, 64, 8), device="cuda")
    a = torch.empty((1, 37, 64), device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.ssd_scan(x, dta, bm, bm, chunk=16)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.rglru_scan(a, a)
    assert entered == ["SsdScanFn", "RglruScanFn"]
    states = torch.empty((1, 4, 4, 16, 8), device="cuda")
    ctx = types.SimpleNamespace(saved_tensors=(x.detach(), dta, bm, bm, states), chunk=16)
    with pytest.raises(RuntimeError, match="nvcc"):
        ssd_mod.SsdScanFn.backward(ctx, torch.empty_like(x),
                                   torch.empty((1, 4, 16, 8), device="cuda"))
    ctx = types.SimpleNamespace(saved_tensors=(a.detach(), a.detach()), b_dtype=a.dtype)
    with pytest.raises(RuntimeError, match="nvcc"):
        rglru_mod.RglruScanFn.backward(ctx, torch.empty_like(a))
    assert no_plain == []


@pytest.mark.parametrize("fn,params", [
    ("ssd_scan", {"x", "dt_a", "b_mat", "c_mat", "chunk", "initial_state",
                  "return_all_states"}),
    ("rglru_scan", {"a", "b"}),
])
def test_ssd_dispatch_has_no_plain_route(fn, params):
    """The scans name no schedule: nothing but the device picks the path,
    so no argument can send a CUDA tensor to the plain version."""
    import inspect
    assert set(inspect.signature(getattr(ops, fn)).parameters) == params


@pytest.mark.parametrize("impl,exc", [("pallas", None),
                                      ("ref", ValueError),
                                      ("nope", ValueError)])
def test_dispatch_has_no_plain_route(monkeypatch, impl, exc):
    """Only the kernel schedules are nameable: ``"pallas"`` dispatches decode
    to the legacy wrapper and prefill to the chunked one, and no
    impl value selects the plain version."""
    q = torch.zeros((1, 4, 16))
    kp = torch.zeros((2, 4, 2, 16))
    bt = torch.zeros((1, 2), dtype=torch.int32)
    cl = torch.ones((1,), dtype=torch.int32)
    if exc is None:
        calls = []
        for name in ("_legacy", "_splitk", "_chunked"):
            monkeypatch.setattr(ops, name, lambda *a, name=name: calls.append(name))
        ops.paged_attention(q, kp, kp, bt, cl, impl=impl)
        ops.chunked_prefill_attention(q, kp[0], kp[0], 0, impl=impl)
        assert calls == ["_legacy", "_chunked"]
        return
    with pytest.raises(exc):
        ops.paged_attention(q, kp, kp, bt, cl, impl=impl)
    with pytest.raises(exc):
        ops.chunked_prefill_attention(q, kp[0], kp[0], 0, impl=impl)


def test_non_cpu_non_cuda_device_raises():
    """The attention kernels take no meta tensor. The scans' meta route is
    shape-only (tests/test_torch_multidevice.py) and still checks shapes;
    any other device raises."""
    import types
    q = torch.empty((1, 4, 16), device="meta")
    with pytest.raises(ValueError):
        pa_mod.paged_attention_splitk(q, q, q, q, q)
    with pytest.raises(ValueError):
        cp_mod.chunked_prefill_attention(q, q, q, 0)
    with pytest.raises(ValueError):
        ssd_mod.ssd_scan(q[None], q, q, q, chunk=4)
    with pytest.raises(ValueError):
        pa_mod.paged_attention(q, q, q, q, q)
    with pytest.raises(ValueError):
        rglru_mod.rglru_scan(q, q[:, :3])
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError):
        rglru_mod.rglru_scan(other, other)
    with pytest.raises(ValueError):
        ssd_mod.ssd_scan(other, other, other, other, chunk=4)


def test_port_module_list_covers_the_state_path():
    """The import-hygiene tests walk every module of the port, the state,
    hybrid and MoE paths', the simulator, every config and the training
    path's included."""
    names = _module_names()
    for mod in ("repro_torch.kernels.ssd_scan", "repro_torch.models.ssm",
                "repro_torch.models.state_cache",
                "repro_torch.configs.mamba2_1_3b",
                "repro_torch.kernels.rglru_scan", "repro_torch.models.rglru",
                "repro_torch.configs.recurrentgemma_9b",
                "repro_torch.core.simulator", "repro_torch.models.moe",
                "repro_torch.configs.yi_9b", "repro_torch.configs.codeqwen1_5_7b",
                "repro_torch.configs.granite_34b",
                "repro_torch.configs.qwen3_moe_30b_a3b",
                "repro_torch.training.optimizer", "repro_torch.training.train_step",
                "repro_torch.training.data", "repro_torch.training.checkpoint",
                "repro_torch.launch.train"):
        assert mod in names


def test_chip_smoke_fails_without_card():
    """chip_smoke exits non-zero and prints no result line without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
