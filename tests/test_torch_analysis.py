"""repro_torch.analysis, the port's linters and lock sanitizer, against
repro.analysis on the same inputs, on the CPU.

1. The gate: the port's checkers over ``src/repro_torch`` find nothing.
2. Locks: both packages' checkers give the same (code, path, line) on
   every lock fixture of ``tests/test_analysis.py`` and on both trees.
3. Syncs: the port's SYNC002 agrees with repro's on the conversions both
   know (``np.asarray``, ``.item()``, ``.tolist()``) and also flags the
   torch ones; SYNC001 fires in ``torch.compile`` / ``torch.jit.script``
   / ``torch.cuda.graph`` scopes only; ``core/engine.py``'s sanctioned
   syncs each state their frequency.
4. Contracts: every CUDA kernel wrapper has its plain version in the
   port's own ``kernels/ref.py``, with both trees in one project.
5. The sanitizer: under ``REPRO_SANITIZE=1`` (a subprocess: the variable
   is read when the guarded classes are decorated, at import) an
   off-lock write to a guarded field raises ``SanitizeError`` in each of
   the seven guarded classes and a write under the lock does not;
   without it the locks are plain and nothing raises.
6. The quickstart example against the reference quickstart's calls.
"""
import json
import re
import textwrap
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

import repro.core as jcore
import test_analysis as ref_fixtures
from conftest import run_subprocess
from repro.analysis import Project as JProject
from repro.analysis import locks as jlocks
from repro.analysis import syncs as jsyncs
from repro.analysis.cli import load_project as jload_project
from repro.data import random_walk
from repro_torch.analysis import Project, contracts, locks, run_analysis
from repro_torch.analysis import cli, sanitize, syncs
from repro_torch.analysis.common import SourceFile
from repro_torch.examples import quickstart

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = str(SRC / "repro_torch")


def _project(*named):
    return Project.from_sources(
        [(path, textwrap.dedent(src)) for path, src in named])


def _key(findings):
    return [(f.code, f.path, f.line) for f in findings]


def _both(check_t, check_j, *named):
    """The port's and repro's findings on the same sources."""
    jp = JProject.from_sources(
        [(path, textwrap.dedent(src)) for path, src in named])
    return _key(check_t(_project(*named))), _key(check_j(jp))


# -- 1. the gate --------------------------------------------------------------

def test_port_tree_has_zero_findings():
    project, parse_errors = cli.load_project([PORT])
    assert not parse_errors
    findings = run_analysis(project)
    assert findings == [], "\n".join(f.text() for f in findings)
    assert len(project.files) > 60


def test_cli_exit_code_is_one_iff_findings(tmp_path, capsys):
    bad = tmp_path / "counter.py"
    bad.write_text(ref_fixtures.BAD_LOCK)
    assert cli.main([str(bad), "--format", "github"]) == 1
    out = capsys.readouterr().out
    assert f"::error file={bad},line=13,title=LOCK001::" in out
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert cli.main([str(good)]) == 0


# -- 2. lock parity -----------------------------------------------------------

_OFFLOCK_READ = """\
class C:
    def __init__(self):
        self.items = []   # guarded by: _lock

    def peek(self):
        return len(self.items)
"""

_NESTED = """\
class C:
    def __init__(self):
        self.n = 0   # guarded by: _lock

    def spawn(self):
        with self._lock:
            def later():
                self.n += 1     # runs off-thread, lock NOT held
            return later
"""

LOCK_FIXTURES = {
    "offlock_mutation": ("svc/counter.py", ref_fixtures.BAD_LOCK),
    "clean": ("svc/counter.py", ref_fixtures.BAD_LOCK.replace(
        "    def bad(self):\n        self.n += 1\n", "")),
    "offlock_read": ("c.py", _OFFLOCK_READ),
    "caller_holds": ("cache.py", ref_fixtures.CALLER_HOLDS),
    "unannotated_helper": ("cache.py", ref_fixtures.CALLER_HOLDS.replace(
        "        # caller holds self._lock\n", "")),
    "nested_function": ("c.py", _NESTED),
}
LOCK_EXPECTED = {
    "offlock_mutation": [("LOCK001", "svc/counter.py", 13)],
    "clean": [],
    "offlock_read": [("LOCK001", "c.py", 6)],
    "caller_holds": [("LOCK002", "cache.py", 17)],
    "unannotated_helper": [("LOCK001", "cache.py", 9)],
    "nested_function": [("LOCK001", "c.py", 8)],
}


@pytest.mark.parametrize("name", sorted(LOCK_FIXTURES))
def test_lock_checker_matches_reference(name):
    got, want = _both(locks.check, jlocks.check, LOCK_FIXTURES[name])
    assert got == want == LOCK_EXPECTED[name]


@pytest.mark.parametrize("tree", ["repro", "repro_torch"])
def test_lock_checker_matches_reference_on_tree(tree):
    path = str(SRC / tree)
    tproject, _ = cli.load_project([path])
    jproject, _ = jload_project([path])
    assert _key(locks.check(tproject)) == _key(jlocks.check(jproject))
    assert len(tproject.files) == len(jproject.files) > 30


# -- 3. syncs -----------------------------------------------------------------

_SHARED_SYNCS = """\
# repro: sync-trace
import numpy as np

def host_sched(lb, gids, x):
    a = np.asarray(lb)
    b = np.asarray(lb)          # sync
    c = np.asarray(gids)        # host ids
    d = np.array(x)
    e = x.item()
    f = x.item()                # sync: once per batch
    g = x.tolist()
    h = x.tolist()              # host
    return a, b, c, d, e, f, g, h
"""


def test_sync002_matches_reference_on_shared_conversions():
    got, want = _both(syncs.check, jsyncs.check, ("engineish.py",
                                                  _SHARED_SYNCS))
    assert got == want == [("SYNC002", "engineish.py", line)
                           for line in (5, 8, 9, 11)]


def test_sync002_without_directive_flags_nothing():
    src = _SHARED_SYNCS.replace("# repro: sync-trace\n", "")
    got, want = _both(syncs.check, jsyncs.check, ("m.py", src))
    assert got == want == []


_TORCH_SYNCS = """\
# repro: sync-trace
import numpy as np
import torch

def walk(x, ev, host):
    a = x.cpu()
    b = x.numpy()
    c = x.to("cpu")
    d = x.to(device="cpu")
    torch.cuda.synchronize()
    ev.synchronize()
    if bool((x < 0).any()):
        pass
    n = int(x.sum())
    m = float(x.max())
    z = x.to("cuda")
    s = float(host)
    t = int(np.max(host))
    u = bool(x.mean())
    return a, b, c, d, n, m, z, s, t, u
"""
_TORCH_FLAGGED = (6, 7, 8, 9, 10, 11, 12, 14, 15)


def test_sync002_flags_torch_conversions():
    findings = syncs.check(_project(("walk.py", _TORCH_SYNCS)))
    assert [(f.code, f.line) for f in findings] == \
        [("SYNC002", line) for line in _TORCH_FLAGGED]


@pytest.mark.parametrize("note", ["# sync: once per trip", "# host"])
def test_sync002_suppressions_clear_torch_conversions(note):
    lines = _TORCH_SYNCS.splitlines()
    for line in _TORCH_FLAGGED:
        lines[line - 1] += "  " + note
    src = "\n".join(lines) + "\n"
    assert syncs.check(_project(("walk.py", src))) == []


SYNC001_CASES = {
    "compile_decorator": ("""\
import torch

@torch.compile
def f(x):
    y = x + 1
    return y.item()
""", [6]),
    "compile_call_args": ("""\
import functools
import torch

@torch.compile(fullgraph=True)
def f(x):
    return float(x)

@functools.partial(torch.compile, mode="reduce-overhead")
def g(x):
    return x.cpu()
""", [6, 10]),
    "compile_of_a_name": ("""\
import torch

def step(x):
    return int(x)

def host(x):
    return int(x)

fast = torch.compile(step)
""", [4]),
    "jit_script": ("""\
import torch

@torch.jit.script
def f(x):
    return bool(x)
""", [5]),
    "cuda_graph": ("""\
import torch

def capture(g, x):
    y = float(x)
    with torch.cuda.graph(g):
        z = x.tolist()
        def inner():
            return x.numpy()
    return y, z, inner
""", [6, 8]),
    "plain_function": ("""\
import numpy as np
import torch

def f(x):
    return float(x), np.asarray(x), x.item(), x.cpu()
""", []),
}


@pytest.mark.parametrize("name", sorted(SYNC001_CASES))
def test_sync001_fires_in_traced_scopes_only(name):
    src, lines = SYNC001_CASES[name]
    findings = syncs.check(_project(("m.py", src)))
    assert [(f.code, f.line) for f in findings] == \
        [("SYNC001", line) for line in lines]


def test_sync001_annotation_is_the_sanctioned_suppression():
    src = SYNC001_CASES["compile_decorator"][0].replace(
        "return y.item()", "return y.item()   # sync")
    assert syncs.check(_project(("m.py", src))) == []


def test_engine_sync_sites_state_their_frequency():
    path = SRC / "repro_torch" / "core" / "engine.py"
    sf = SourceFile(path=str(path), source=path.read_text())
    assert sf.sync_trace_module()
    sites = syncs.sync_sites(sf)
    freqs = [f for _, f in sites]
    assert set(freqs) == {"batch", "trip", "block", "group", "chunk"}
    lines = sf.source.splitlines()
    # the three per-step syncs are the device predicates of the walks
    for freq in ("trip", "block", "chunk"):
        (line,) = [ln for ln, f in sites if f == freq]
        assert re.search(r"bool\(.*\.any\(\)\)", lines[line - 1])


# -- 4. contracts -------------------------------------------------------------

REF_OK = """\
import torch

def foo_ref(x, *, k):
    return x

def bar_oracle(x):
    return x
"""

KERNEL_FOO = """\
import torch

launches = 0

def _lib():
    return None

def foo(x, *, k, tile_n=128):
    return x
"""


def test_port_wrappers_pass_the_oracle_contract():
    project, _ = cli.load_project([PORT])
    assert contracts.check(project) == []
    wrappers = [f for f in project.files
                if contracts.is_wrapper(f.module)]
    assert len(wrappers) == 7


def test_oracle_contract_passes_and_strips_tuning_params():
    p = _project(("src/repro_torch/kernels/foo.py", KERNEL_FOO),
                 ("src/repro_torch/kernels/ref.py", REF_OK))
    assert contracts.check_oracles(p) == []


def test_missing_oracle_is_flagged():
    p = _project(("src/repro_torch/kernels/foo.py",
                  KERNEL_FOO.replace("def foo(", "def fresh(")),
                 ("src/repro_torch/kernels/ref.py", REF_OK))
    findings = contracts.check_oracles(p)
    assert [(f.code, f.line) for f in findings] == [("KERN001", 8)]
    assert "fresh_ref" in findings[0].message


def test_oracle_signature_mismatch_is_flagged():
    ref = REF_OK.replace("def foo_ref(x, *, k):", "def foo_ref(x, *, kk):")
    p = _project(("src/repro_torch/kernels/foo.py", KERNEL_FOO),
                 ("src/repro_torch/kernels/ref.py", ref))
    assert [f.code for f in contracts.check_oracles(p)] == ["KERN003"]


def test_oracle_override_comment():
    src = KERNEL_FOO.replace(
        "def foo(x, *, k, tile_n=128):",
        "def bar(x, tile_n=128):   # oracle: bar_oracle")
    p = _project(("src/repro_torch/kernels/bar.py", src),
                 ("src/repro_torch/kernels/ref.py", REF_OK))
    assert contracts.check_oracles(p) == []


def test_missing_ref_module_is_flagged():
    p = _project(("src/repro_torch/kernels/foo.py", KERNEL_FOO))
    assert [f.code for f in contracts.check_oracles(p)] == ["KERN002"]


def test_both_trees_resolve_the_ports_own_ref():
    project, errors = cli.load_project([str(SRC / "repro"), PORT])
    assert not errors
    assert contracts.check(project) == []
    # an oracle only the JAX package's ref.py has does not satisfy a port
    # wrapper, whichever ref.py the project lists first
    for order in (1, -1):
        p = _project(*[("src/repro/kernels/ref.py",
                        REF_OK.replace("bar_oracle", "fresh_ref")),
                       ("src/repro_torch/kernels/ref.py", REF_OK)][::order],
                     ("src/repro_torch/kernels/foo.py",
                      KERNEL_FOO.replace("def foo(", "def fresh(")))
        assert [f.code for f in contracts.check_oracles(p)] == ["KERN001"]


# -- 5. the runtime sanitizer -------------------------------------------------

_GUARDED_CODE = """
import json, os, sys, threading
import numpy as np
import torch
from repro_torch import core, storage
from repro_torch.analysis import sanitize
from repro_torch.serve.coalescer import AdmissionCoalescer
from repro_torch.storage.format import ArrayFileWriter, IndexFileWriter
from repro_torch.storage.pipeline.driver import (BuildReport, _DigestClock,
                                                  _UnitRecorder)

tmp = sys.argv[1]
raw = np.random.default_rng(0).standard_normal((64, 16)).astype(np.float32)
storage.save_index(core.build(raw, capacity=16, device="cpu"),
                   os.path.join(tmp, "s.dsix"))
opened = storage.open_index(os.path.join(tmp, "s.dsix"), device="cpu")
sess = storage.SearchSession(opened, cache_blocks=4, device="cpu")
report = BuildReport(resumed=False, stages={})
aw = ArrayFileWriter(os.path.join(tmp, "a.bin"), kind="runs",
                     specs={"x": {"shape": [4], "dtype": "float32",
                                  "offset": 0}})
iw = IndexFileWriter(os.path.join(tmp, "i.dsix"), n=8, w=4, card=4,
                     capacity=4, n_real=16, n_blocks=4)
iw.append_raw_rows(np.zeros((4, 8), np.float32))   # a locked path
cases = {  # class -> (instance, its lock, a guarded field)
    "AdmissionCoalescer": (AdmissionCoalescer(sess), "_admit_lock",
                           "_pending"),
    "BlockCache": (sess.cache, "_lock", "demand_misses"),
    "SearchSession": (sess, "_coalescer_lock", "_coalescer"),
    "ArrayFileWriter": (aw, "_lock", "_f"),
    "IndexFileWriter": (iw, "_lock", "_raw_rows"),
    "_UnitRecorder": (_UnitRecorder(None, report, None), "_lock", "_man"),
    "_DigestClock": (_DigestClock(report), "_lock", "_report"),
}
out = {"enabled": sanitize.enabled()}
for name, (obj, lock_name, field) in cases.items():
    lock = getattr(obj, lock_name)
    value = getattr(obj, field)
    with lock:
        setattr(obj, field, value)                  # held: fine
    try:
        setattr(obj, field, value)                  # off-lock
        raised = None
    except sanitize.SanitizeError as e:
        raised = str(e)
    out[name] = {"lock": type(lock).__name__,
                 "plain": isinstance(lock, type(threading.Lock())),
                 "offlock_raised": raised}
sess.close()
aw.abort()
iw.abort()
print("RESULT " + json.dumps(out))
"""

GUARDED = ("AdmissionCoalescer", "BlockCache", "SearchSession",
           "ArrayFileWriter", "IndexFileWriter", "_UnitRecorder",
           "_DigestClock")
_SANITIZE_RUNS: dict = {}


@pytest.fixture(scope="module")
def sanitize_run(tmp_path_factory):
    """armed -> what ``_GUARDED_CODE`` saw, one subprocess each."""
    def run(armed: bool) -> dict:
        if armed not in _SANITIZE_RUNS:
            tmp = tmp_path_factory.mktemp(f"san{int(armed)}")
            env = ("os.environ['REPRO_SANITIZE'] = '1'" if armed
                   else "os.environ.pop('REPRO_SANITIZE', None)")
            out = run_subprocess(
                f"import os, sys; {env}; sys.argv[1:] = [{str(tmp)!r}]\n"
                + _GUARDED_CODE, devices=1, timeout=300)
            line = [ln for ln in out.splitlines()
                    if ln.startswith("RESULT ")][-1]
            _SANITIZE_RUNS[armed] = json.loads(line[len("RESULT "):])
        return _SANITIZE_RUNS[armed]
    return run


@pytest.mark.parametrize("name", GUARDED)
def test_sanitize_offlock_write_raises(sanitize_run, name):
    got = sanitize_run(True)
    assert got["enabled"]
    assert got[name]["lock"] == "InstrumentedLock"
    msg = got[name]["offlock_raised"]
    assert msg is not None and name in msg and "REPRO_SANITIZE=1" in msg


@pytest.mark.parametrize("name", GUARDED)
def test_sanitize_off_means_plain_locks(sanitize_run, name):
    got = sanitize_run(False)
    assert not got["enabled"]
    assert got[name]["plain"] and got[name]["offlock_raised"] is None


def test_instrumented_lock_tracks_owner_across_threads():
    lock = sanitize.InstrumentedLock()
    seen = []
    with lock:
        th = threading.Thread(target=lambda: seen.append(lock.held_by_me()))
        th.start()
        th.join(timeout=30)
        assert lock.held_by_me() and lock.locked()
    assert seen == [False] and not lock.held_by_me()


# -- 6. the quickstart --------------------------------------------------------

def test_quickstart_matches_reference(capsys):
    n = 8000
    assert quickstart.main(["--n-series", str(n), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    got = re.findall(r"query (\d+): nn=\s*(\d+) dist=\s*([\d.]+) "
                     r"refined (\d+) / (\d+) series", out)
    assert len(got) == 10 and "verified: answers identical" in out
    # the reference quickstart's calls at the same size
    raw = jnp.asarray(random_walk(n, 256, seed=0))
    queries = jnp.asarray(random_walk(10, 256, seed=1))
    res = jcore.search(jcore.build(raw, capacity=1024), queries)
    want_idx = np.asarray(res.idx)[:, 0]
    want_ref = np.asarray(res.stats.series_refined)
    for i, (q, nn, dist, refined, total) in enumerate(got):
        assert (int(q), int(nn), int(refined), int(total)) == \
            (i, int(want_idx[i]), int(want_ref[i]), n)
        assert abs(float(dist) - float(res.dist[i, 0])) <= 1e-4
