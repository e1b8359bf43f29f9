"""Copied from hinge_tpu/config.py: the logic verbatim, the imports rewritten to
hinge_tpu_torch.

Configuration for the assembly pipeline.

Mirrors the reference's two-level config: an INI file with sections
``[filter] [running] [layout] [draft] [consensus]`` plus per-call-site
defaults (reference: `src/lib/INIReader.cpp`, `utils/nominal.ini`,
`parameter_description.md`).

The reference parses INI values with C `strtol`/`strtod`, which tolerate
trailing junk such as the ``;`` line terminators used in ``nominal.ini``
(`INIReader.cpp:31-48`): ``length_threshold = 1000;`` parses as 1000, while
``GetBoolean`` does an exact (lowercased) string match so ``true;`` falls back
to the default (`INIReader.cpp:50-61`).  We reproduce both behaviors so a
user's existing nominal.ini produces identical parameters.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional


def _parse_ini(text: str) -> dict:
    """Parse INI text with inih semantics (reference `src/lib/ini.c`).

    - `;` / `#` full-line comments
    - inline `;` comments only when preceded by whitespace (ini.c:44-54)
    - names/values are whitespace-stripped; keys are lowercased
      (INIReader.cpp:63-70)
    """
    values: dict = {}
    section = ""
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line[0] in ";#":
            continue
        if line[0] == "[":
            end = _find_char_or_comment(line[1:], "]")
            if end is not None and line[1 + end] == "]":
                section = line[1 : 1 + end]
            continue
        eq = _find_char_or_comment(line, "=")
        if eq is None or line[eq] != "=":
            eq = _find_char_or_comment(line, ":")
        if eq is not None and eq < len(line) and line[eq] in "=:":
            name = line[:eq].strip()
            value = line[eq + 1 :]
            cmt = _find_inline_comment(value)
            if cmt is not None:
                value = value[:cmt]
            values[(section.lower(), name.lower())] = value.strip()
    return values


def _find_char_or_comment(s: str, c: str) -> Optional[int]:
    was_ws = False
    for i, ch in enumerate(s):
        if ch == c or (was_ws and ch == ";"):
            return i
        was_ws = ch.isspace()
    return None


def _find_inline_comment(s: str) -> Optional[int]:
    was_ws = False
    for i, ch in enumerate(s):
        if was_ws and ch == ";":
            return i
        was_ws = ch.isspace()
    return None


_INT_RE = re.compile(r"^\s*[+-]?(0[xX][0-9a-fA-F]+|\d+)")
_REAL_RE = re.compile(r"^\s*[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")


class IniReader:
    """Drop-in equivalent of the reference INIReader (C strto* semantics)."""

    def __init__(self, path_or_text: str, *, is_text: bool = False):
        if is_text:
            text = path_or_text
        else:
            try:
                with open(path_or_text) as f:
                    text = f.read()
            except OSError:
                self.parse_error = -1
                self._values = {}
                return
        self.parse_error = 0
        self._values = _parse_ini(text)

    def get(self, section: str, name: str, default: str = "") -> str:
        return self._values.get((section.lower(), name.lower()), default)

    def get_integer(self, section: str, name: str, default: int) -> int:
        v = self.get(section, name, "")
        m = _INT_RE.match(v)
        if not m:
            return default
        return int(m.group(0), 0)

    def get_real(self, section: str, name: str, default: float) -> float:
        v = self.get(section, name, "")
        m = _REAL_RE.match(v)
        if not m:
            return default
        return float(m.group(0))

    def get_boolean(self, section: str, name: str, default: bool) -> bool:
        v = self.get(section, name, "").lower()
        if v in ("true", "yes", "on", "1"):
            return True
        if v in ("false", "no", "off", "0"):
            return False
        return default

    # configparser-style accessors used by the reference clip script
    # (pruning_and_clipping.py:1256-1277): getint raises on trailing junk.
    def getint_strict(self, section: str, name: str) -> int:
        v = self.get(section, name, None)
        if v is None:
            raise KeyError((section, name))
        return int(v)  # raises ValueError on "500000;" like configparser


@dataclasses.dataclass
class FilterParams:
    """[filter] section. Defaults = reference call-site defaults
    (filter.cpp:377-405, maximal.cpp:445-480)."""

    length_threshold: int = -1
    quality_threshold: float = 0.0
    n_iter: int = -1
    aln_threshold: int = -1
    min_cov: int = -1
    cut_off: int = -1
    theta: int = -1
    theta2: int = 0
    est_cov: int = 0  # "ec": 0 => estimate from data
    reso: int = 40  # hard-coded in reference (filter.cpp:386)
    use_qv: bool = True
    coverage: bool = True
    coverage_frac_repeat_annotation: int = 3
    min_repeat_annotation_threshold: int = 10
    max_repeat_annotation_threshold: int = 20
    repeat_annotation_gap_threshold: int = 300
    no_hinge_region: int = 500
    hinge_min_support: int = 7
    hinge_min_pileup: int = 7
    hinge_unbridged: int = 6
    hinge_bin: int = 100  # overwritten with 2*hinge_tolerance_length (filter.cpp:405)
    hinge_tolerance_length: int = 100
    qv_threshold: int = 40  # hard-coded binarization threshold (filter.cpp:311)


@dataclasses.dataclass
class RunningParams:
    n_proc: int = 4


@dataclasses.dataclass
class LayoutParams:
    """[layout] section (hinging.cpp:784-812)."""

    hinge_slack: int = 1000
    hinge_tolerance: int = 150
    kill_hinge_overlap: int = 300
    kill_hinge_internal: int = 40
    matching_hinge_slack: int = 200
    num_events_telomere: int = 7
    min_connected_component_size: int = 8
    use_two_matches: bool = True
    keep_only_matches_between_maximal_reads: bool = True
    del_telomeres: bool = False
    # REFERENCE QUIRK: filter.cpp:406 reads the SINGULAR key
    # "layout/del_telomere" for flag writing, while hinging.cpp:803 and
    # pruning_and_clipping.py:1268 read the PLURAL "del_telomeres" — the
    # yeast_W303 demo ini sets only the singular, so only the filter-stage
    # cov.flag/self.flag path triggers there.
    del_telomere: bool = False
    # read by clip (pruning_and_clipping.py:1259-1277)
    max_plasmid_length: int = 500000
    aggressive_pruning: bool = False


@dataclasses.dataclass
class DraftParams:
    """[draft] section (draft.cpp:970-974)."""

    min_cov: int = -1
    trim: int = -1
    edge_safe: int = -1
    tspace: int = -1
    step: int = -1


@dataclasses.dataclass
class ConsensusParams:
    """[consensus] section (consensus.cpp:93)."""

    min_length: int = -1
    trim_end: int = 200
    best_n: int = 1
    quality_threshold: float = 0.23


@dataclasses.dataclass
class Config:
    filter: FilterParams = dataclasses.field(default_factory=FilterParams)
    running: RunningParams = dataclasses.field(default_factory=RunningParams)
    layout: LayoutParams = dataclasses.field(default_factory=LayoutParams)
    draft: DraftParams = dataclasses.field(default_factory=DraftParams)
    consensus: ConsensusParams = dataclasses.field(default_factory=ConsensusParams)

    @classmethod
    def from_ini(cls, path_or_text: str, *, is_text: bool = False) -> "Config":
        r = IniReader(path_or_text, is_text=is_text)
        c = cls()
        f, lay, d, cons = c.filter, c.layout, c.draft, c.consensus

        f.length_threshold = r.get_integer("filter", "length_threshold", -1)
        f.quality_threshold = r.get_real("filter", "quality_threshold", 0.0)
        f.n_iter = r.get_integer("filter", "n_iter", -1)
        f.aln_threshold = r.get_integer("filter", "aln_threshold", -1)
        f.min_cov = r.get_integer("filter", "min_cov", -1)
        f.cut_off = r.get_integer("filter", "cut_off", -1)
        f.theta = r.get_integer("filter", "theta", -1)
        f.theta2 = r.get_integer("filter", "theta2", 0)
        f.est_cov = r.get_integer("filter", "ec", 0)
        f.use_qv = r.get_boolean("filter", "use_qv", True)
        f.coverage = r.get_boolean("filter", "coverage", True)
        f.coverage_frac_repeat_annotation = r.get_integer(
            "filter", "coverage_frac_repeat_annotation", 3
        )
        f.min_repeat_annotation_threshold = r.get_integer(
            "filter", "min_repeat_annotation_threshold", 10
        )
        f.max_repeat_annotation_threshold = r.get_integer(
            "filter", "max_repeat_annotation_threshold", 20
        )
        f.repeat_annotation_gap_threshold = r.get_integer(
            "filter", "repeat_annotation_gap_threshold", 300
        )
        f.no_hinge_region = r.get_integer("filter", "no_hinge_region", 500)
        f.hinge_min_support = r.get_integer("filter", "hinge_min_support", 7)
        f.hinge_min_pileup = r.get_integer("filter", "hinge_min_pileup", 7)
        f.hinge_unbridged = r.get_integer("filter", "hinge_unbridged", 6)
        f.hinge_tolerance_length = r.get_integer("filter", "hinge_tolerance_length", 100)
        # reference overwrites hinge_bin after reading it (filter.cpp:405)
        f.hinge_bin = 2 * f.hinge_tolerance_length

        c.running.n_proc = r.get_integer("running", "n_proc", 4)

        lay.hinge_slack = r.get_integer("layout", "hinge_slack", 1000)
        lay.hinge_tolerance = r.get_integer("layout", "hinge_tolerance", 150)
        lay.kill_hinge_overlap = r.get_integer("layout", "kill_hinge_overlap", 300)
        lay.kill_hinge_internal = r.get_integer("layout", "kill_hinge_internal", 40)
        lay.matching_hinge_slack = r.get_integer("layout", "matching_hinge_slack", 200)
        lay.num_events_telomere = r.get_integer("layout", "num_events_telomere", 7)
        lay.min_connected_component_size = r.get_integer(
            "layout", "min_connected_component_size", 8
        )
        lay.use_two_matches = bool(r.get_integer("layout", "use_two_matches", 1))
        lay.keep_only_matches_between_maximal_reads = bool(
            r.get_integer("layout", "keep_only_matches_between_maximal_reads", 1)
        )
        lay.del_telomeres = bool(r.get_integer("layout", "del_telomeres", 0))
        lay.del_telomere = bool(r.get_integer("layout", "del_telomere", 0))
        # clip reads these two via configparser.getint: trailing junk -> default
        try:
            lay.max_plasmid_length = r.getint_strict("layout", "max_plasmid_length")
        except (KeyError, ValueError):
            lay.max_plasmid_length = 500000
        try:
            lay.aggressive_pruning = r.getint_strict("layout", "aggressive_pruning") == 1
        except (KeyError, ValueError):
            lay.aggressive_pruning = False

        d.min_cov = r.get_integer("draft", "min_cov", -1)
        d.trim = r.get_integer("draft", "trim", -1)
        d.edge_safe = r.get_integer("draft", "edge_safe", -1)
        d.tspace = r.get_integer("draft", "tspace", -1)
        d.step = r.get_integer("draft", "step", -1)

        cons.min_length = r.get_integer("consensus", "min_length", -1)
        cons.trim_end = r.get_integer("consensus", "trim_end", 200)
        cons.best_n = r.get_integer("consensus", "best_n", 1)
        cons.quality_threshold = r.get_real("consensus", "quality_threshold", 0.23)
        return c


#: The default parameter set shipped with the reference (utils/nominal.ini).
NOMINAL_INI = """\
[filter]
length_threshold = 1000;
quality_threshold = 0.23;
n_iter = 3;
aln_threshold = 1000;
min_cov = 5;
cut_off = 300;
theta = 300;
use_qv = true;

[running]
n_proc = 12;

[draft]
min_cov = 10;
trim = 200;
edge_safe = 100;
tspace = 900;
step = 50;

[consensus]
min_length = 4000;
trim_end = 200;
best_n = 1;
quality_threshold = 0.23;

[layout]
hinge_slack = 1000
min_connected_component_size = 8
"""


def nominal_config() -> Config:
    """Config matching the reference demo runs (utils/nominal.ini)."""
    return Config.from_ini(NOMINAL_INI, is_text=True)
