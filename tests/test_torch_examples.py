"""The port's example CLIs of this slice, driven through ``main()`` on temp
files beside the JAX package's: the two triangle estimators, weighted
matching (with its MovieLens mode), iterative CC, and the CC CLI's
``--device-encode``.

Mirrors ``tests/test_examples.py:97``, ``:109``, ``:119`` and ``:155``.
"""

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.example import centralized_weighted_matching as jax_matching
from gelly_streaming_tpu.example import iterative_connected_components as jax_icc
from gelly_streaming_tpu_torch import native
from gelly_streaming_tpu_torch.example import (
    broadcast_triangle_count,
    centralized_weighted_matching,
    connected_components,
    incidence_sampling_triangle_count,
    iterative_connected_components,
)

TRIANGLES_DATA = (
    "1 2 100\n1 3 150\n3 2 200\n2 4 250\n3 4 300\n3 5 350\n4 5 400\n"
    "4 6 450\n6 5 500\n5 7 550\n6 7 600\n8 6 650\n7 8 700\n7 9 750\n"
    "8 9 800\n10 8 850\n9 10 900\n9 11 950\n10 11 1000\n"
)


def test_sampling_examples_run(tmp_path):
    inp = tmp_path / "edges.txt"
    inp.write_text("\n".join(" ".join(ln.split()[:2]) for ln in TRIANGLES_DATA.splitlines()))
    out1, out2 = tmp_path / "r1.txt", tmp_path / "r2.txt"
    broadcast_triangle_count.main(["--cpu", str(inp), "12", "500", str(out1)])
    incidence_sampling_triangle_count.main(["--cpu", str(inp), "12", "500", str(out2)])
    assert out1.read_text() == out2.read_text()
    lines = out1.read_text().splitlines()
    assert lines and all(ln.startswith("(") for ln in lines)
    assert int(lines[-1].strip("()").split(",")[0]) <= 19


def test_matching_example_equals_jax(tmp_path, capsys):
    inp = tmp_path / "edges.txt"
    inp.write_text("1 2 10\n2 3 25\n3 4 15\n")
    out, jout = tmp_path / "result.txt", tmp_path / "jax.txt"
    centralized_weighted_matching.main([str(inp), str(out)])
    assert "Matching weight: 25.0" in out.read_text()
    assert "Runtime:" in capsys.readouterr().out
    jax_matching.main([str(inp), str(jout)])
    assert out.read_text() == jout.read_text()


def test_iterative_cc_example_equals_jax(tmp_path):
    inp = tmp_path / "edges.txt"
    inp.write_text("5 6\n1 2\n2 6\n")
    out, jout = tmp_path / "result.txt", tmp_path / "jax.txt"
    iterative_connected_components.main(["--cpu", str(inp), "1", str(out)])
    assert out.read_text().splitlines()[-2:] == ["(5,1)", "(6,1)"]
    jax_icc.main([str(inp), "1", str(jout)])
    assert out.read_text() == jout.read_text()


def test_matching_movielens_mode(tmp_path, capsys):
    p = tmp_path / "u.data"
    rng = np.random.default_rng(3)
    p.write_text("".join(
        f"{rng.integers(1, 50)}\t{rng.integers(1, 80)}\t{rng.integers(1, 6)}\t0\n"
        for _ in range(200)))
    centralized_weighted_matching.main(["--movielens", str(p)])
    out = capsys.readouterr().out
    assert "Matching weight:" in out and "Runtime:" in out
    jax_matching.main(["--movielens", str(p)])
    jout = capsys.readouterr().out
    def pick(text):
        return [ln for ln in text.splitlines() if not ln.startswith("Runtime")]

    assert pick(out) == pick(jout)


@pytest.mark.parametrize("bound", ["64", "0"])
def test_cc_cli_device_encode(tmp_path, capsys, bound):
    """``--device-encode <id bound>`` (a bound, or 0 for growth mode) runs
    the dense carry to the components of the plain run."""
    rng = np.random.default_rng(8)
    p = tmp_path / "e.txt"
    native.write_edge_file(str(p), rng.integers(0, 60, 200), rng.integers(0, 60, 200))
    plain = connected_components.run_corpus(str(p), 16, device="cpu")
    capsys.readouterr()
    connected_components.main(["--cpu", "--corpus", str(p), "16", "--device-encode", bound])
    out = capsys.readouterr().out
    assert f"components: {len(plain.components)} (carry: dense)" in out
    got = connected_components.run_corpus(str(p), 16, device="cpu", device_encode=True,
                                          id_bound=int(bound))
    assert sorted(got.component_sets()) == sorted(plain.component_sets())


@pytest.mark.parametrize("cli", [broadcast_triangle_count, incidence_sampling_triangle_count,
                                 iterative_connected_components])
def test_clis_raise_without_a_card_unless_told_cpu(monkeypatch, capsys, cli):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([])
    cli.main(["--cpu"])
    assert "Usage" in capsys.readouterr().out
