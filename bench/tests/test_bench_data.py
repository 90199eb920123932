"""The seeded generators: the same seed gives the same arrays, the shapes
and d are the configurations' own."""
import json

import numpy as np
import pytest
import torch

from bench.data import chain, graph
from bench.tests.layout import REPO, SMALL

KINDS = {"ocr": chain, "horseseg": graph}
SEED = 2 ** 31 + 7


def _cfg(name, **over):
    cfg = json.loads((REPO / "bench" / "configs" / f"{name}.json")
                     .read_text())
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("name", ["ocr", "horseseg"])
def test_same_seed_same_arrays(name):
    cfg = _cfg(name, **SMALL[name])
    gen = KINDS[name].generate
    a = gen(cfg, SEED, torch.device("cpu"))
    b = gen(cfg, SEED, torch.device("cpu"))
    c = gen(cfg, SEED + 1, torch.device("cpu"))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["x"], c["x"])


@pytest.mark.parametrize("name,d", [("ocr", 4004), ("horseseg", 1298)])
def test_shapes_and_d_at_published_widths(name, d):
    cfg = _cfg(name, n=3)
    assert cfg["d"] == d
    arrays = KINDS[name].generate(cfg, SEED, torch.device("cpu"))
    problem = KINDS[name].problem(arrays, cfg)
    assert problem.d == d and problem.n == 3
    x = arrays["x"]
    if name == "ocr":
        assert x.shape == (3, 14, 128)
    else:
        assert x.shape == (3, 256, 649)
        assert arrays["edges"].shape == (3, 2 * 256 - 32, 2)


def test_chain_recipe():
    cfg = _cfg("ocr", **SMALL["ocr"])
    a = chain.generate(cfg, SEED, torch.device("cpu"))
    lengths = a["mask"].sum(1)
    assert int(lengths.min()) >= 3 and int(lengths.max()) <= cfg["max_len"]
    # Valid positions are a prefix; nothing lives past a sequence's end.
    assert torch.equal(a["mask"], torch.arange(cfg["max_len"])[None]
                       < lengths[:, None])
    assert not a["x"][~a["mask"]].any() and not a["y"][~a["mask"]].any()
    assert int(a["y"].max()) < cfg["num_labels"]


def test_graph_lattice_is_the_ports():
    from repro_torch.data.synthetic import horseseg_like
    cfg = _cfg("horseseg", **SMALL["horseseg"])
    a = graph.generate(cfg, SEED, torch.device("cpu"))
    _, _, _, edges, _, color = horseseg_like(n=1, grid=(6, 6), f=4)
    np.testing.assert_array_equal(a["edges"][0].numpy(), edges[0])
    np.testing.assert_array_equal(a["color"][0].numpy(), color[0])
