"""repro_torch.analysis.kernels: the checker's kernels layer (rules H003,
H004), the counterpart of ``repro/analysis/hlo.py``'s tile and compile
rules.

On the CPU: the reference's ``check_tiles`` and the port's H003 are
clean on the sweep; each H003 rule catches a plan patched to break it,
also through the CLI's ``--strict``; the source tables, the waivers and
the one shared-memory limit; the ``-Xptxas -v`` parser and the mangled
names on canned logs; H004's checks on faked attributes, and that off the
card H004 says it did not run.  A ``gpu``-marked test runs H004 on the
card.  The reference is imported inside the one test that needs it, so
the card's test run (``--noconftest -m gpu``) needs no jax.
"""
import json
import re

import pytest
import torch

from repro_torch.analysis import RULES, run_all
from repro_torch.analysis import kernels as K
from repro_torch.analysis.__main__ import main
from repro_torch.kernels import _build
from repro_torch.kernels import approx_pass as t_ap
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import gram as t_gram
from repro_torch.kernels import plane_scores as t_ps
from repro_torch.kernels import plane_select as t_psel


@pytest.fixture(scope="module")
def srcs():
    return K.sources()


def _launches(part):
    """The launches of one part of the sweep, and the count refused."""
    launches, refused = [], 0
    for _, thunk in K.SWEEPS[part]():
        try:
            launches.extend(thunk())
        except ValueError:
            refused += 1
    return launches, refused


# ---------------------------------------------------------------------------
# H003 on the sweep


@pytest.mark.parametrize("part", ["jax", "reference", "paths", "configs"])
def test_the_sweep_is_clean(srcs, part):
    """The reference's ``check_tiles`` on its own sweep (``jax``), and the
    port's H003 on each part of its sweep (the reference's shapes mapped
    onto the kernels, the paths' shapes, the configs'), find nothing."""
    if part == "jax":
        from repro.analysis.hlo import check_tiles
        assert check_tiles() == []
        return
    launches, _ = _launches(part)
    assert launches
    assert [f for l in launches for f in K.check_launch(l, srcs[l.kernel])
            ] == []


def test_the_sweep_reaches_every_build_of_every_table(srcs):
    launches, refused = K.plan_launches()
    assert K.check_plans(launches, srcs) == []
    reached = {(l.kernel, l.build) for l in launches}
    assert reached == {(n, b) for n, s in srcs.items() for b in s.builds}
    # The plans refuse what no build takes (fp32 MLA, C past one block,
    # the gap output in Sec-3.5 mode), and nothing of the paths.
    assert refused["flash_attention"] and refused["viterbi"]
    assert _launches("paths")[1] == 0


def test_the_source_tables(srcs):
    counts = {n: len(s.builds) for n, s in srcs.items()}
    assert counts == {"plane_scores": 2, "plane_select": 2, "viterbi": 18,
                      "moe_ffn": 6, "flash_attention": 29, "gram": 2,
                      "approx_pass": 30}
    assert [n for n, s in srcs.items() if s.nonportable] == ["gram"]
    fa = srcs["flash_attention"].builds
    assert sum(b.endswith("true>") for b in fa) == 11       # the -s16 builds
    assert "flash_attention_bf16_kernel<192, 128, 4, 64, 0, false>" in fa
    for s in srcs.values():
        assert len(set(s.builds)) == len(s.builds)


def test_head_dim_112_launches_the_padded_128_build(srcs):
    for score in ("f32", "bf16"):
        (l,) = K.flash_launches(2, 1024, 32, 32, 112, 112, "bfloat16",
                                "causal", score)
        assert l.build == ("flash_attention_bf16_kernel<128, 128, 4, 64, 0, "
                           f"{'true' if score == 'bf16' else 'false'}>")
        assert ("q/k head dim", 112, 128) in l.holds
        assert K.check_launch(l, srcs["flash_attention"]) == []


def test_one_shared_memory_limit():
    """The plans, the sources and the checker read one constant: no
    source or plan module spells the number."""
    for mod in (t_ap, t_fa, t_psel, K):
        src = open(mod.__file__).read()
        assert "232448" not in src, mod.__name__
    for name in _build.SOURCES:
        assert "232448" not in (_build.CSRC / f"{name}.cu").read_text()
    assert t_psel.SMEM_LIMIT is _build.SMEM_LIMIT == 232448
    assert f"-DREPRO_SMEM_LIMIT={_build.SMEM_LIMIT}" in _build.NVCC_FLAGS


def test_spill_waivers_name_builds_with_reasons(srcs):
    waived = {n: K.waivers(n) for n in srcs}
    assert sorted(waived["approx_pass"]) == sorted(
        f"approx_pass_kernel<{nj}, {m}>" for nj, m in (
            (40, "false, false, false"), (24, "true, false, false"),
            (24, "true, false, true"), (40, "true, false, false"),
            (40, "true, false, true")))
    for name, table in waived.items():
        for build, why in table.items():
            assert build in srcs[name].builds and len(why) > 20


# ---------------------------------------------------------------------------
# H003: each rule catches a broken plan


def _over_the_limit(mp):
    mp.setattr(t_ps, "smem_bytes", lambda rows, stages: _build.SMEM_LIMIT + 16)
    return K.plane_scores_launches(64, 4004), "shared memory"


def _misaligned(mp):
    mp.setattr(t_ap, "_slot", lambda length: (length + 6 + 3) // 4 * 4 + 1)
    return K.approx_launches(4004, 64, 0, False, 1), "not a multiple of 16"


def _unknown_build(mp):
    """Head dim 112 keyed to a build of its own, not the padded 128."""
    plan = t_fa.plan

    def unpadded(D, *a, **k):
        p = plan(D, *a, **k)
        return (dict(p, build=p["build"].replace("128x128", "112x112"))
                if D == 112 else p)

    mp.setattr(t_fa, "plan", unpadded)
    return (K.flash_launches(2, 1024, 32, 32, 112, 112, "bfloat16", "causal",
                             "f32"), "no such build")


def _tile_not_whole(mp):
    plan = t_fa.plan
    mp.setattr(t_fa, "plan", lambda *a, **k: dict(plan(*a, **k), bk=40))
    return (K.flash_launches(2, 1024, 8, 8, 64, 64, "bfloat16", "causal",
                             "f32"), "not whole")


def _cluster_past_16(mp):
    mp.setattr(t_gram, "plan", lambda n, d: (32, 32))
    return K.gram_launches(64, 4004), "cluster of 32 CTAs > 16"


def _too_many_threads(mp):
    mp.setattr(t_ps, "plan", lambda n: (64, 2))
    return K.plane_scores_launches(4096, 4004), "threads a CTA"


def _grid_past_the_card(mp):
    return K.moe_launches(70000, 64, 2048, 1024, "bfloat16"), "grid z"


@pytest.mark.parametrize("fault", [
    _over_the_limit, _misaligned, _unknown_build, _tile_not_whole,
    _cluster_past_16, _too_many_threads, _grid_past_the_card],
    ids=lambda f: f.__name__.strip("_"))
def test_h003_flags_a_broken_plan(srcs, monkeypatch, fault):
    launches, what = fault(monkeypatch)
    found = [f for l in launches for f in K.check_launch(l, srcs[l.kernel])]
    assert found and all(f.rule == "H003" for f in found)
    hit = [f for f in found if what in f.message]
    assert hit, [str(f) for f in found]
    kernel = launches[0].kernel
    assert hit[0].where.startswith(f"kernels/{kernel}.py::plan(")
    assert launches[0].build in hit[0].message


def test_h003_flags_a_cluster_of_16_without_the_non_portable_flag(srcs):
    (l,) = K.gram_launches(64, 4004)
    assert l.cluster == 16 and K.check_launch(l, srcs["gram"]) == []
    text = (_build.CSRC / "gram.cu").read_text().replace(
        "cudaFuncAttributeNonPortableClusterSizeAllowed", "")
    portable = K.read_source("gram", text)
    assert portable.builds == srcs["gram"].builds
    (f,) = K.check_launch(l, portable)
    assert (f.rule, f.where) == ("H003", "kernels/gram.py::plan(n=64, "
                                         "d=4004)")
    assert "cluster of 16 CTAs > 8" in f.message
    assert "non-portable" in f.message


def test_h003_flags_unreached_builds_and_bad_waivers(srcs, monkeypatch):
    launches = [l for l in K.plan_launches()[0]
                if l.build != "gram_kernel<128>"]
    monkeypatch.setattr(t_ps, "SPILL_WAIVERS",
                        {"plane_scores_kernel<8>": "no such build"},
                        raising=False)
    found = {(f.rule, f.where, f.message) for f in K.check_plans(launches,
                                                                 srcs)}
    assert found == {
        ("H003", "kernels/csrc/gram.cu",
         "gram_kernel<128>: no plan of the sweep reaches this build"),
        ("H003", "kernels/plane_scores.py::SPILL_WAIVERS",
         "plane_scores_kernel<8>: a waiver needs a build of the source's "
         "table and a reason")}


@pytest.mark.parametrize("fault", [_over_the_limit, _misaligned,
                                   _unknown_build],
                         ids=lambda f: f.__name__.strip("_"))
def test_cli_strict_exits_1_on_a_broken_plan(monkeypatch, capsys, fault):
    fault(monkeypatch)
    argv = ["--strict", "--device", "cpu", "--layer", "kernels"]
    assert main(argv) == 1
    out = capsys.readouterr().out
    assert re.search(r"^H003 kernels/\w+\.py::plan\(", out, re.M), out
    assert main(argv[1:]) == 0                 # reported, exit 0


# ---------------------------------------------------------------------------
# The -Xptxas -v log


_ENTRY = ("_ZN43_GLOBAL__N__988b0321_10_moe_ffn_cu_054e555f14moe_ffn_kernelI"
          "13__nv_bfloat16Li8ELi1EEEvPKT_S4_S4_S4_PS2_iii")
_LOG_SPILL = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{_ENTRY}' for 'sm_90a'
ptxas info    : Function properties for {_ENTRY}
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compile time = 21.5 ms
"""
_APPROX = ("_ZN47_GLOBAL__N__38eab7d2_14_approx_pass_cu_237faba918approx_pass"
           "_kernelILi40ELb1ELb0ELb1EEEvNS_4ArgsEPfx")
_LOG_CLEAN = f"""ptxas info    : Compiling entry function '{_APPROX}' for 'sm_90a'
ptxas info    : Function properties for {_APPROX}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 104 registers, used 1 barriers
ptxas info    : Compile time = 190.9 ms
"""


@pytest.mark.parametrize("log,build,want", [
    (_LOG_SPILL, "moe_ffn_kernel<__nv_bfloat16, 8, 1>", (40, 8, 8, 8)),
    (_LOG_CLEAN, "approx_pass_kernel<40, true, false, true>",
     (104, 0, 0, 0))], ids=["spill", "clean"])
def test_ptxas_log_parser(log, build, want):
    entries = K.parse_ptxas(log)
    assert len(entries) == 1
    e = K.ptxas_entry(entries, build)
    assert (e.registers, e.stack, e.spill_stores, e.spill_loads) == want
    assert K.ptxas_entry(entries, build.replace("8", "16", 1)
                         .replace("40", "24")) is None


@pytest.mark.parametrize("build,fragment", [
    ("plane_scores_kernel<4>", "19plane_scores_kernelILi4EE"),
    ("flash_attention_kernel<float, 64, 2>",
     "22flash_attention_kernelIfLi64ELi2EE"),
    ("moe_ffn_kernel<__nv_bfloat16, 32, 2>",
     "14moe_ffn_kernelI13__nv_bfloat16Li32ELi2EE"),
    ("approx_pass_wide_kernel<true, false, true>",
     "23approx_pass_wide_kernelILb1ELb0ELb1EE")])
def test_mangled_names(build, fragment):
    assert K._mangled(build) == fragment


# ---------------------------------------------------------------------------
# H004's checks, on faked attributes


_PS_LOG = "".join(
    f"ptxas info    : Compiling entry function '_ZN4_GLOBAL__N__x19plane_"
    f"scores_kernelILi{s}EEEvPKfxS2_S2_xPfii' for 'sm_90a'\n"
    f"ptxas info    : Function properties for _ZN4_GLOBAL__N__x19plane_"
    f"scores_kernelILi{s}EEEvPKfxS2_S2_xPfii\n"
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    "ptxas info    : Used 32 registers, used 0 barriers\n" for s in (4, 2))


def _fake_card(monkeypatch, **change):
    """plane_scores's two builds on a fake card: ``change`` overrides
    build 0's attributes (``log`` its ptxas log, ``builds`` the table)."""
    base = dict(registers=32, static_smem=0, local_bytes=0, max_threads=1024,
                max_dyn_smem=131072, resident=4, binary_version=90, builds=2)
    log = change.pop("log", _PS_LOG)

    def attributes(name, index, threads=0, dyn_smem=0, cluster=1):
        a = dict(base, builds=change.get("builds", 2))
        if index >= a["builds"]:
            return dict(a, rc=1)
        if index == 0:
            a.update(change)
        return dict(a, rc=0)

    monkeypatch.setattr(_build, "build", lambda names=None: {})
    monkeypatch.setattr(_build, "build_log", lambda name: log)
    monkeypatch.setattr(_build, "attributes", attributes)
    monkeypatch.setattr(t_ps, "_lib", lambda: None)


@pytest.mark.parametrize("change,what", [
    ({}, None),
    ({"local_bytes": 8}, "not waived"),
    ({"max_dyn_smem": 49152}, "its init grants"),
    ({"static_smem": 16}, "static shared memory"),
    ({"max_threads": 32}, "threads >"),
    ({"resident": 0}, "resident"),
    ({"log": _PS_LOG.replace("Used 32", "Used 33", 1)}, "-Xptxas -v says"),
    ({"log": ""}, "no single entry function"),
    ({"builds": 3}, "the library's table holds 3 builds")],
    ids=["clean", "spill", "granted", "static", "threads", "resident",
         "ptxas", "no-log", "table"])
def test_h004_checks_on_a_fake_card(srcs, monkeypatch, change, what):
    _fake_card(monkeypatch, **change)
    launches = [l for l in K.plan_launches()[0] if l.kernel == "plane_scores"]
    found, facts = K.check_builds(launches,
                                  {"plane_scores": srcs["plane_scores"]})
    assert all(f.rule == "H004" for f in found)
    if what is None:
        assert found == []
        f = facts["kernels:plane_scores"]
        assert f["per_build"]["plane_scores_kernel<4>"] == {
            "registers": 32, "local": 0, "granted": 131072, "smem": 65536,
            "resident": 4}
        del f["per_build"]
        assert f == {"builds": 2, "registers": [32, 32], "max_smem": 131072,
                     "spills": {}, "waived": [], "waived_without_spill": []}
    else:
        assert [f for f in found if what in f.message], [str(f) for f in
                                                         found]


def test_h004_waives_a_waived_spill(srcs, monkeypatch):
    _fake_card(monkeypatch, local_bytes=8)
    monkeypatch.setattr(t_ps, "SPILL_WAIVERS",
                        {"plane_scores_kernel<4>": "a reason long enough to "
                         "read"}, raising=False)
    launches = [l for l in K.plan_launches()[0] if l.kernel == "plane_scores"]
    found, facts = K.check_builds(launches,
                                  {"plane_scores": srcs["plane_scores"]})
    assert found == []
    assert facts["kernels:plane_scores"]["waived"] == [
        "plane_scores_kernel<4>"]


# ---------------------------------------------------------------------------
# Off the card, and the wiring


def test_off_the_card_h004_says_it_did_not_run():
    findings, facts = K.run_kernel_layer("cpu")
    assert findings == []
    assert facts["kernels"]["h004"].startswith("not run: it needs a CUDA "
                                               "device")
    assert facts["kernels"]["h003_launches"] > 1000
    assert not [k for k in facts if k.startswith("kernels:")]


def test_without_a_card_h004_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        K.run_kernel_layer("cuda")
    with pytest.raises(RuntimeError, match="kernels layer"):
        main(["--layer", "kernels"])


def test_cli_and_run_all_carry_the_kernels_layer(capsys):
    assert main(["--strict", "--device", "cpu", "--layer", "kernels",
                 "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert set(rep) == {"ok", "layers", "findings", "facts"}
    assert rep["ok"] and rep["layers"] == ["kernels"]
    assert rep["facts"]["kernels"]["h004"].startswith("not run")
    assert {"H003", "H004"} <= set(RULES)
    report = run_all(layers=["kernels"], device="cpu")
    assert report.ok and "h004=not run" in report.format_text()


# ---------------------------------------------------------------------------
# On the card


@pytest.mark.gpu
def test_h004_on_the_card_finds_no_unwaived_fault():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    findings, facts = K.run_kernel_layer("cuda")
    assert findings == [], [str(f) for f in findings]
    assert facts["kernels"]["h004"].startswith("run on ")
    for name, src in K.sources().items():
        f = facts[f"kernels:{name}"]
        assert f["builds"] == len(src.builds)
        assert set(f["spills"]) == set(f["waived"]) <= set(K.waivers(name))
