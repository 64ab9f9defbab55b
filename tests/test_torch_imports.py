"""Import isolation of the PyTorch port: godot_whisper_tpu_torch and its
chip scripts import neither JAX nor the JAX package, statically or at run
time."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "godot_whisper_tpu_torch"
MODULES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "profile_torch_main_path.py",
                                        ROOT / "kernel_device_times.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "godot_whisper_tpu")


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(ROOT)) for p in MODULES])
def test_module_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_port_runtime_leaves_jax_unloaded():
    """Importing the port and building a CPU nano context (mel included)
    must not pull JAX into the process."""
    code = (
        "import sys, numpy as np, torch\n"
        "import godot_whisper_tpu_torch as gt\n"
        "cfg = gt.get_config('tiny.en').replace(n_audio_layer=1, "
        "n_text_layer=1, n_audio_state=64, n_audio_head=2, "
        "n_text_state=64, n_text_head=2)\n"
        "ctx = gt.WhisperContext.from_params(cfg, gt.init_params(cfg, "
        "compute_dtype=torch.float32, device='cpu'), device='cpu')\n"
        "ctx.pipeline.set_audio(np.zeros(16000, np.float32))\n"
        "print('jax' in sys.modules, 'godot_whisper_tpu' in sys.modules)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(PORT.parent) + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=str(PORT.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"], out.stdout


def test_cli_runtime_leaves_jax_unloaded(tmp_path):
    """The port's CLI, run on the CPU over a checkpoint and a WAV that the
    port itself wrote, must not pull JAX into the process either."""
    code = (
        "import sys, numpy as np, torch\n"
        "import godot_whisper_tpu_torch as gt\n"
        "from godot_whisper_tpu_torch.audio.mel import mel_filterbank\n"
        "from godot_whisper_tpu_torch.audio.tokenizer import "
        "synthetic_vocab\n"
        "from godot_whisper_tpu_torch.audio.wav import write_wav\n"
        "from godot_whisper_tpu_torch.cli.main import main\n"
        "from godot_whisper_tpu_torch.models.export_ggml import "
        "export_checkpoint\n"
        "cfg = gt.get_config('tiny.en').replace(n_audio_layer=1, "
        "n_text_layer=1, n_audio_state=64, n_audio_head=2, "
        "n_text_state=64, n_text_head=2)\n"
        "p = gt.init_params(cfg, compute_dtype=torch.float32, device='cpu')\n"
        f"export_checkpoint({str(tmp_path / 'm.bin')!r}, p, cfg, "
        "mel_filterbank(80), synthetic_vocab(cfg))\n"
        f"write_wav({str(tmp_path / 'a.wav')!r}, "
        "np.zeros(22050, np.float32), 22050)\n"
        f"rc = main(['-m', {str(tmp_path / 'm.bin')!r}, "
        f"{str(tmp_path / 'a.wav')!r}, '--device', 'cpu', '--no-prints', "
        "'-otxt', '--best-of', '1', '--temperature-inc', '0'])\n"
        "print(rc, 'jax' in sys.modules, 'godot_whisper_tpu' in sys.modules)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(PORT.parent) + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "False", "False"], out.stdout
    assert (tmp_path / "a.wav.txt").exists()


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "profile_torch_main_path.py"])
def test_chip_scripts_refuse_without_cuda(script):
    """Without a CUDA device the chip scripts exit non-zero and print no
    result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / script)],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
