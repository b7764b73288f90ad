"""The port's launchers, ``repro_torch.launch.train`` and
``repro_torch.launch.serve``, through ``main(argv)`` on the CPU at the
reduced size: they run, print the reference launchers' fields, and
refuse what the reference's refuse."""
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402


def test_train_launcher_runs_reduced_on_cpu(capsys, tmp_path):
    ckpt = tmp_path / "c.npz"
    train_launch.main(["--reduced", "--device", "cpu", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--checkpoint",
                       str(ckpt)])
    out = capsys.readouterr().out
    assert re.search(r"^step     0 loss \d+\.\d{4} \(\d+ ms/step\)$", out,
                     re.M), out
    assert re.search(r"^final loss \d+\.\d{4} \(first \d+\.\d{4}\) over 3 "
                     r"steps$", out, re.M), out
    assert ckpt.exists()


def test_train_launcher_refuses_a_full_model_on_cpu():
    with pytest.raises(SystemExit, match="use --reduced on CPU"):
        train_launch.main(["--arch", "qwen2.5-3b", "--device", "cpu"])


def test_launchers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main in (train_launch.main, serve_launch.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--reduced"] if main is train_launch.main else [])


def test_serve_launcher_runs_reduced_on_cpu(capsys):
    serve_launch.main(["--device", "cpu", "--duration", "6", "--fps", "2",
                       "--strategy", "switch_a"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("arch=qwen2.5-3b-smoke strategy=switch_a "
                        "clock=virtual")
    assert re.match(r"stream: \d+/\d+ served \(\d+ dropped, rate "
                    r"\d\.\d{3}\), measured downtime \d+\.\d{2} ms over \d+ "
                    r"switches$", lines[-2]), lines
    assert re.match(r"latency: p50 \d+\.\d ms, p99 \d+\.\d ms; edge "
                    r"utilisation \d+\.\d%, cloud \d+\.\d%$", lines[-1]), lines
    for w in lines[1:-2]:
        assert re.match(r"  t=\s*\d+\.\d+s split \d+->\d+ measured window",
                        w), w
