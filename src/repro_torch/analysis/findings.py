"""Finding records and reports shared by the checker's layers (PyTorch
port of ``repro/analysis/findings.py``).

A :class:`Finding` is one violated contract: a rule id (``J0xx`` program,
``R0xx`` source lint, ``H00x`` kernels), *where* it was found (an engine
name, a ``file:line`` or a plan's call) and a message.  Layers return
plain lists of findings; :class:`Report` aggregates them for the CLI (a
text table or JSON, and the exit code).  The rule ids and the report's
JSON shape are the reference's.

The reference's ``H001``/``H002`` check XLA's optimized HLO against the
jaxpr's collectives; a torch program has no HLO, and J001/J002 stand in
for them (not in :data:`RULES`).  Its ``H003``/``H004`` (the Pallas
tiles, every program compiles) are the kernels layer's, for the port's
hand-written CUDA kernels.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List

#: rule id -> one-line description (the CLI prints this table on --rules).
RULES: Dict[str, str] = {
    # Layer 1: program contracts, counted on one run of each program
    "J001": "per-pass collective count differs from the engine's "
            "declared collectives_per_pass budget",
    "J002": "setup (once per program) collective count differs from the "
            "declared collectives_setup budget",
    "J003": "host sync inside a dispatch (.item()/float() of a tensor, a "
            "device-to-host copy, a data-dependent shape, a blocking "
            "upload) beyond the declared host_callbacks budget",
    "J004": "mesh-capable engine does not declare collective budgets",
    "J005": "dtype discipline: float64 value in a dispatched program, or "
            "dual telemetry not carried in the declared accum_dtype",
    "J006": "obs drain contract: a multipass engine's outer iteration "
            "must return the on-device ObsMetrics counters as () int32 "
            "tensors inside its stats (so the obs layer rides the "
            "existing single host sync and adds no sync of its own)",
    "J007": "policy contract: capability-declared policy names must "
            "resolve in the repro_torch.policy registry (exactly one "
            "sampling + one eviction + one oracle), and keyed "
            "gap-sampling engines must return gap_total (() float32) "
            "and gap_sampled in the same stats read",
    "J008": "serving contract: a registered DecodeEngine's per-round "
            "batched decode must stay one clean dispatch: no host sync "
            "beyond the batcher's one, no collective, no float64 value "
            "(serving is single-device; the batcher's ServeLedger "
            "asserts the same 1-dispatch/1-sync round at run time)",
    "J009": "async pipelining contract: an async_oracle engine's outer "
            "iteration must dispatch exactly two programs (one "
            "async_oracle, one async_cache), with no host sync and no "
            "collective inside the oracle program (it must overlap the "
            "cache program), and no read-after-write hazard between "
            "them (the cache program must not read what the concurrent "
            "oracle program wrote, or the pipeline serializes)",
    # Layer 3: the kernels' launch plans and builds
    "H003": "a kernel plan's launch does not fit the card or its build: "
            "shared memory past the opt-in limit, a 16-byte copy, TMA box "
            "or stride misaligned, a wgmma/mma.sync tile not whole, a "
            "grid, block or cluster past the card's limits, or a build "
            "the source's table lacks (or one no plan reaches)",
    "H004": "a kernel build does not compile, load or fit on the card: "
            "a plan's shared memory past the build's granted maximum, "
            "local memory (a spill) not waived, threads past its maximum, "
            "no CTA resident, or its -Xptxas -v log disagreeing with the "
            "card's attributes",
    # Layer 2: AST source lint
    "R001": "raw +/-1e30 sentinel literal outside kernels/ops.py "
            "(use kernels.ops.INVALID_SCORE)",
    "R002": "removed WorkSet/GramCache/driver.run spelled anywhere, or "
            "a retired shim module still present in the tree",
    "R003": "direct torch.distributed collective in repro_torch.shard "
            "outside CollectiveTrace and DataMesh (collectives must be "
            "counted)",
    "R004": "implicit host sync (float()/np.asarray()/.item()/.tolist()/"
            ".cpu()/.numpy()/synchronize(), or a blocking upload from "
            "pageable memory) in an engine/kernel hot path",
    "R005": "float64 dtype in device code (fp32 accumulation "
            "discipline)",
}


@dataclass(frozen=True)
class Finding:
    """One contract violation."""

    rule: str            # e.g. "J001"
    where: str           # engine name or "path/to/file.py:42"
    message: str

    def __str__(self) -> str:  # pragma: no cover - formatting
        return f"{self.rule} {self.where}: {self.message}"


@dataclass
class Report:
    """Aggregated findings from one checker run."""

    findings: List[Finding] = field(default_factory=list)
    #: layers that actually ran, e.g. ["program", "lint"]
    layers: List[str] = field(default_factory=list)
    #: per-engine facts, e.g. {"mpbcfw-shard": {"outer_setup": 1, ...}}
    facts: Dict[str, Dict[str, object]] = field(default_factory=dict)

    def extend(self, findings: List[Finding]) -> None:
        self.findings.extend(findings)

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> str:
        return json.dumps({
            "ok": self.ok,
            "layers": self.layers,
            "findings": [{"rule": f.rule, "where": f.where,
                          "message": f.message} for f in self.findings],
            "facts": self.facts,
        }, indent=2, sort_keys=True)

    def format_text(self, verbose: bool = False) -> str:
        lines: List[str] = []
        for f in sorted(self.findings, key=lambda f: (f.rule, f.where)):
            lines.append(str(f))
        if verbose or not self.findings:
            for name in sorted(self.facts):
                facts = self.facts[name]
                kv = " ".join(f"{k}={facts[k]}" for k in sorted(facts))
                lines.append(f"# {name}: {kv}")
        status = "OK" if self.ok else f"{len(self.findings)} finding(s)"
        lines.append(f"repro_torch.analysis [{' + '.join(self.layers)}]: "
                     f"{status}")
        return "\n".join(lines)


def rule_table() -> str:
    """The J/H/R rule listing."""
    return "\n".join(f"{rid}  {desc}" for rid, desc in sorted(RULES.items()))
