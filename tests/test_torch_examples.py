"""The port's example CLIs of this slice, driven through ``main()`` on temp
files beside the JAX package's: the two triangle estimators, weighted
matching (with its MovieLens mode), iterative CC, and the CC CLI's
``--device-encode`` and checkpoint flags (``--checkpoint``,
``--checkpoint-dir``, ``--every``, ``--resume``, ``--fresh``).

Mirrors ``tests/test_examples.py:97``, ``:109``, ``:119``, ``:155``,
``:272-300`` and ``:305`` (sharded ingest feeding live serving).
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


def test_cc_supervised_checkpoint_dir_flags(tmp_path, capsys):
    """``--checkpoint-dir`` runs the CC example supervised; a re-run resumes
    from the barrier by default with the same output, ``--fresh`` discards
    it; both equal the JAX package's CLI (mirrors
    ``tests/test_examples.py:272``)."""
    import os

    from gelly_streaming_tpu.example import connected_components as jax_cc

    inp = tmp_path / "e.txt"
    inp.write_text("".join(f"{k} {k + 2}\n" for k in range(1, 41)))
    out = str(tmp_path / "out.txt")
    ckdir = str(tmp_path / "ck")

    connected_components.main(["--cpu", str(inp), "8", out, "--checkpoint-dir", ckdir,
                               "--every", "2"])
    capsys.readouterr()
    first = open(out).read()
    assert os.path.exists(os.path.join(ckdir, "cc.ckpt"))
    jax_cc.main([str(inp), "8", str(tmp_path / "jax.txt")])
    assert first == (tmp_path / "jax.txt").read_text()

    connected_components.main(["--cpu", str(inp), "8", out, "--checkpoint-dir", ckdir,
                               "--every", "2", "--resume"])
    assert "resuming from barrier at window 4" in capsys.readouterr().out
    assert open(out).read() == first

    connected_components.main(["--cpu", str(inp), "8", out, "--checkpoint-dir", ckdir,
                               "--every", "2", "--fresh"])
    assert "resuming" not in capsys.readouterr().out
    assert open(out).read() == first


def test_cc_checkpoint_barriers_cross_the_clis(tmp_path, capsys):
    """A barrier the JAX package's CLI left (``--every auto``) resumes in the
    port's CLI, and the reverse, with the same output."""
    from gelly_streaming_tpu.example import connected_components as jax_cc

    inp = tmp_path / "e.txt"
    rng = np.random.default_rng(5)
    inp.write_text("".join(f"{a} {b}\n" for a, b in rng.integers(0, 90, (120, 2))))
    for writer, reader in ((jax_cc.main, connected_components.main),
                           (connected_components.main, jax_cc.main)):
        ck = str(tmp_path / f"{writer.__module__}.ckpt")
        wout, rout = str(tmp_path / "w.txt"), str(tmp_path / "r.txt")
        cpu = ["--cpu"] if writer is connected_components.main else []
        writer(cpu + [str(inp), "16", wout, "--checkpoint", ck, "--every", "auto"])
        capsys.readouterr()
        cpu = ["--cpu"] if reader is connected_components.main else []
        reader(cpu + [str(inp), "16", rout, "--checkpoint", ck])
        assert "resuming from barrier" in capsys.readouterr().out
        assert open(rout).read() == open(wout).read()


@pytest.mark.parametrize("args", [
    ["--every", "2"], ["--fresh"], ["--resume"], ["--checkpoint"], ["--every", "x", "--checkpoint", "c"],
])
def test_cc_checkpoint_flag_misuse_prints_usage(tmp_path, capsys, args):
    inp = tmp_path / "e.txt"
    inp.write_text("1 2\n")
    connected_components.main(["--cpu", str(inp), "8"] + args)
    assert "Usage: connected_components" in capsys.readouterr().out
    with pytest.raises(ValueError, match="edge-file form"):
        connected_components.main(["--cpu", "--corpus", str(inp), "--checkpoint-dir",
                                   str(tmp_path / "d")])


def test_cc_checkpointed_cli_raises_without_a_card_unless_told_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inp = tmp_path / "e.txt"
    inp.write_text("1 2\n2 3\n")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        connected_components.main([str(inp), "2", "--checkpoint-dir", str(tmp_path / "d")])


def test_sharded_ingest_serving_example():
    """ShardedEdgeSource feeds a LIVE aggregation + serving stack: the
    example's final answers match a union-find oracle over the same
    synthesized stream, and the JAX package's example on the same
    arguments gives the same final lines; without a card the default
    device raises."""
    from _uf import union_find_components

    from gelly_streaming_tpu.example import sharded_ingest_serving as jax_sis
    from gelly_streaming_tpu_torch.example import sharded_ingest_serving

    nv, ne, seed = 1 << 9, 1 << 12, 23
    rng = np.random.default_rng(seed)
    src = rng.integers(0, nv, ne, dtype=np.int64)
    dst = rng.integers(0, nv, ne, dtype=np.int64)
    queries = [(int(a), int(b)) for a, b in rng.integers(0, nv, (3, 2))]
    comps = union_find_components(zip(src.tolist(), dst.tolist()))
    root_of = {}
    for comp in comps:
        r = min(comp)
        for m in comp:
            root_of[m] = r
    lines = sharded_ingest_serving.run(
        2, 128, ne, queries, n_vertices=nv, seed=seed, device="cpu"
    )
    finals = [ln for ln in lines if ln.startswith("final ")]
    assert len(finals) == len(queries)
    for (u, v), line in zip(queries, finals):
        want = root_of.get(u, u) == root_of.get(v, v)
        assert f"connected({u},{v}) = {want}" in line, (line, want)
    assert any("2-shard live ingest" in ln for ln in lines)
    jlines = jax_sis.run(2, 128, ne, queries, n_vertices=nv, seed=seed)
    # the final window index follows the shards' arrival interleaving;
    # the answers do not
    strip = [ln.split(" [")[0] for ln in finals]
    assert strip == [ln.split(" [")[0] for ln in jlines if ln.startswith("final ")]
    if not torch.cuda.is_available():
        from gelly_streaming_tpu_torch.resilience.errors import DeviceUnavailable

        with pytest.raises(DeviceUnavailable):
            sharded_ingest_serving.run(2, 128, 64, [(0, 1)], n_vertices=16)
