"""The port stands alone: it imports neither JAX nor the JAX package, nor
``msgpack`` (the card's machine lacks it; the checkpoint manifest has the
port's own codec), and its entry points refuse to run quietly on the CPU
when CUDA is absent."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")

PORT_FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "tools").glob("*.py")))


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    names = list(_imported(ast.parse(path.read_text(), str(path))))
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _clean_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_modules_import_without_jax():
    """A fresh interpreter without PYTHONPATH=src (which would load
    src/sitecustomize.py, and JAX with it) imports every module of the
    port; neither jax nor repro ends up in sys.modules."""
    code = (
        "import sys, pkgutil, importlib\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_clean_env(),
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 17


# the cross-replica dW reduction's modules (dist/, the overlapped
# reduce's transports, the pipeline, launch/mesh, quant/compression),
# checked like every port module above and run here in a fresh interpreter
# without JAX
DW_REDUCTION = ("dist/__init__.py", "dist/collectives.py",
                "dist/async_collectives.py", "dist/pipeline.py",
                "launch/mesh.py", "quant/compression.py")


def test_the_dw_reduction_modules_stand_alone():
    assert all(PORT / m in PORT_FILES for m in DW_REDUCTION)
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import torch\n"
        "from repro_torch.dist import compressed_psum, dense_psum\n"
        "from repro_torch.launch import mesh\n"
        "from repro_torch.quant.compression import compress_int8\n"
        "x = torch.arange(300.0)\n"
        "assert torch.equal(dense_psum(x), x)\n"
        "y = compressed_psum(x, (), num_replicas=2)\n"
        "assert y.shape == x.shape and compress_int8(x)[1].numel() == 2\n"
        "from repro_torch.dist import async_collectives as A\n"
        "assert torch.equal(A.ring_all_reduce(x), x)\n"
        "assert torch.equal(A.all_reduce_wait(A.all_reduce_start(\n"
        "    x, (), compressed=True, num_replicas=2)), y)\n"
        "assert A.decide_transport(1 << 20, 4, allow_measure=False) == "
        "'scatter'\n"
        "from repro_torch.dist import pipeline as P\n"
        "w = torch.ones(2, 3)\n"
        "y = P.pipeline_apply(w, torch.ones(4, 3), lambda s, h: h * s,\n"
        "                     schedule='interleaved')\n"
        "assert torch.equal(y, torch.ones(4, 3))\n"
        "assert P.get_schedule('1f1b').plan(4, 8).num_ticks == 15\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_clean_env(),
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


def test_serve_entry_point_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device would run")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--reduced", "--requests", "1", "--max-new", "1"])


def test_train_driver_raises_without_cuda():
    """The train driver runs on CUDA unless ``--device`` names another
    device: without CUDA it raises before it trains or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device would run")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--reduced", "--steps", "1"])


@pytest.mark.parametrize("entry", ["make_train_step", "init_params"])
def test_train_entry_points_raise_without_cuda(entry):
    """The layer engine's step and the model initializer run on CUDA unless
    the caller names another device; without CUDA they raise, and with
    device="cpu" they run."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device would run")
    from repro_torch.configs import get_config
    from repro_torch.core import make_train_step
    from repro_torch.models import lm
    cfg = get_config("qwen1.5-0.5b")
    small = cfg.__class__(**{**cfg.__dict__, "num_layers": 1, "d_model": 64,
                             "num_heads": 2, "num_kv_heads": 2, "d_ff": 64,
                             "vocab_size": 64, "head_dim": None})
    fn = {"make_train_step": lambda **kw: make_train_step(small, **kw),
          "init_params": lambda **kw: lm.init_params(small, **kw)}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn()
    fn(device="cpu")


def test_run_smoke_tree_passes_the_arguments_after_the_dashes(tmp_path):
    """tools/run_smoke_tree.py hands what follows "--" to the other tree's
    chip_smoke.py, with --known given after the tree."""
    (tmp_path / "chip_smoke.py").write_text(
        "class SmokeFailure(Exception): pass\n"
        "def say(m): print(m)\n"
        "def require(c, m): pass\n"
        "def main(argv): print('ARGV', argv); return 0\n")
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "run_smoke_tree.py"),
         str(tmp_path), "--known", "edge C2", "--", "--phases",
         "device,build"], env=_clean_env(), cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ARGV ['--phases', 'device,build']" in out.stdout


def test_chip_smoke_fails_without_cuda():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=_clean_env(), cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
