"""The port's native scanners (``anomod_torch/csrc/native.cpp`` through
``anomod_torch.io.native``) against the JAX package's
(``native/anomod_native.cpp`` through ``anomod.io.native``), on the CPU.

- ``scan_log``, ``summarize_log_files`` / ``Runtime.summarize_logs``,
  ``scan_csv_columns`` and ``scan_api_jsonl`` give the JAX library's
  bytes on a fixed corpus (form feeds, CR, CRLF, U+2028, a missing final
  newline, the 64-byte timestamp window, out-of-range dates, "Exception"
  in any case, quoted CSV commas and newlines, ``strtod``'s hex and
  partial parses, ``nan`` / ``-inf``, ``{}`` and blank JSONL lines) and
  on ``hypothesis`` draws from those tokens; the threaded scan above 1
  MiB at 1-4 threads, with lines across each split point and no ``\\n``
  after one.
- ``parse_log_lines``, ``summarize_log_files``, ``load_tt_metric_csv``
  and ``logscan`` dispatch as the JAX package's do, under
  ``ANOMOD_NATIVE`` unset (both take the library) and ``off`` (both take
  Python): the fast path's rejections, ``default_t``, the Python route's
  ``ValueError`` on a bad date.  A failed build raises under ``auto`` and
  ``on``; nothing falls back quietly.
- The sanitizer smoke's verdict shapes; its full run is ``slow``.

Every comparison needs the JAX library: it comes through one session
fixture, which fails (never skips, never compares against the JAX Python
route) when the library does not load.
"""

import dataclasses
import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import anomod.config as jconfig
import anomod_torch.config as pconfig
from anomod_torch.io import native

LFS_POINTER = ("version https://git-lfs.github.com/spec/v1\n"
               "oid sha256:" + "0" * 64 + "\nsize 123\n")

#: log texts: every row of the two routes' known divergences, and the
#: line-ending, window and case corners
LOGS = {
    "epoch": "1970-01-01 00:00:00 INFO\n",
    "form_feed": "INFO\x0cWARN\nERROR\n",
    "bad_date": "2025-13-45 99:99:99 INFO",
    "crlf": "2025-11-03 22:02:28 INFO a\r\nwarn b\r\n",
    "cr": "2025-11-03 22:02:28 INFO a\rERROR b\r",
    "u2028": "info\u2028 2025-11-03T22:02:30 WARN\u2028x\n",
    "no_final_newline": "x\n2024-02-29T12:00:00 error",
    "window_in": "y" * 45 + "2025-11-03 22:02:28 info\n",
    "window_out": "y" * 46 + "2025-11-03 22:02:28 info\n",
    "exception_case": "eXcEpTiOn\nEXCEPTION\nNullPointerException at 42\n",
    "levels_order": "info warn\nwarn error\nINFO\nDEBUG\n\n",
    "empty": "",
    "newlines": "\n\n\n",
    "non_ascii": "ñ 2025-01-02 03:04:05 Información WARNUNG\n",
    "lfs": LFS_POINTER,
}

#: CSV texts: the fast path's dialect corners
CSVS = {
    "strtod": "h,v\na,0.5\nb,0x10\nc,1_0\nd, 2\n",
    "quoted_comma": 'a,b,c\n"1,5",2,"3"\n"x""y",4,5\n',
    "quoted_newline": 'a,b\n"1\n2",3\n4,5\n',
    "nan_inf": "a,b\nnan,-inf\ninf,NaN\n1e400,-0\n",
    "missing": "a,b,c\n1\n,,\n\n2,3\n",
    "no_final_newline": "a,b\n1,2\n3,4",
    "crlf": "a,b\r\n1,2\r\n3,4\r\n",
}

#: API JSONL texts
JSONLS = {
    "records": ('{"status_code": 200, "latency_ms": 12.5, '
                '"content_length": 512}\n'
                '{"status_code":503,"latency_ms":0x1p4}\n'),
    "empty_and_blank": '{}\n\n  \n{"latency_ms": -inf}\n',
    "partial": '{"status_code": "200", "latency_ms": 1e3x}\n'
               '{"content_length":\n 77}',
    "nan": '{"latency_ms": nan, "status_code": 404.9}\n',
}


def _same(a: np.ndarray, b: np.ndarray) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.fixture(scope="session")
def jnative():
    """The JAX package's native library, loaded once a session."""
    from anomod.io import native as jn
    if not jn.available():
        pytest.fail(f"the JAX native library did not load: "
                    f"{jn.build_error()}")
    return jn


@pytest.fixture
def mode(monkeypatch):
    """Set ``ANOMOD_NATIVE`` (None: unset) for both packages."""
    def set_mode(value):
        if value is None:
            monkeypatch.delenv("ANOMOD_NATIVE", raising=False)
        else:
            monkeypatch.setenv("ANOMOD_NATIVE", value)
        monkeypatch.setattr(jconfig, "_DEFAULT", None)
        monkeypatch.setattr(pconfig, "_DEFAULT", None)
    set_mode(None)
    return set_mode


# -- the scanners, byte for byte ----------------------------------------------

@pytest.mark.parametrize("name", sorted(LOGS))
def test_scan_log_equals_jax(jnative, name):
    text = LOGS[name].encode()
    got, want = native.scan_log(text), jnative.scan_log(text)
    _same(got[0], want[0])
    _same(got[1], want[1])


def _big_log(rng, n_bytes, tail_without_newline=0):
    words = ["INFO", "warn", "Error", "eXcEpTiOn", "debug", "", "info ok"]
    parts, size = [], 0
    while size < n_bytes - tail_without_newline:
        head = (f"2025-{rng.integers(1, 14):02d}-{rng.integers(0, 32):02d} "
                f"{rng.integers(0, 25):02d}:{rng.integers(0, 61):02d}:"
                f"{rng.integers(0, 61):02d} " if rng.random() < 0.8 else "")
        line = head + words[rng.integers(len(words))] + \
            "z" * int(rng.integers(0, 400)) + \
            ("\r\n" if rng.random() < 0.2 else "\n")
        parts.append(line)
        size += len(line)
    parts.append("q" * tail_without_newline)
    return "".join(parts).encode()


@pytest.mark.parametrize("n_threads", [1, 2, 3, 4])
@pytest.mark.parametrize("tail", [0, 700_000])
def test_scan_log_threaded_equals_jax(jnative, n_threads, tail):
    rng = np.random.default_rng(23)
    text = _big_log(rng, (1 << 20) + 12_345, tail_without_newline=tail)
    assert len(text) > 1 << 20
    got = native.scan_log(text, n_threads=n_threads)
    want = jnative.scan_log(text, n_threads=n_threads)
    serial = native.scan_log(text, n_threads=1)
    for g, w, s in zip(got, want, serial):
        _same(g, w)
        _same(g, s)
    assert got[0].shape[0] == text.count(b"\n") + (not text.endswith(b"\n"))


def _log_tree(tmp_path):
    paths = []
    for name in sorted(LOGS):
        p = tmp_path / f"{name}_0.log"
        p.write_bytes(LOGS[name].encode())
        paths.append(p)
    paths.append(tmp_path / "missing_0.log")
    return paths


def test_summarize_log_files_equals_jax(jnative, tmp_path):
    paths = _log_tree(tmp_path)
    got, want = native.summarize_log_files(paths), \
        jnative.summarize_log_files(paths)
    _same(got[0], want[0])
    _same(got[1], want[1])
    i = {p.name: k for k, p in enumerate(paths)}
    assert got[0][i["missing_0.log"]].tolist() == [0, 0, 0, 0, 0]
    assert got[0][i["form_feed_0.log"]].tolist()[:4] == [2, 0, 1, 1]
    assert got[0][i["lfs_0.log"]].tolist() == [3, 0, 0, 0, 128]
    assert native.summarize_log_files([]) is None \
        and jnative.summarize_log_files([]) is None


def test_runtime_summarize_equals_jax(jnative, tmp_path):
    paths = _log_tree(tmp_path)
    with native.Runtime(3) as rt, jnative.Runtime(3) as jrt:
        assert rt.n_threads == 3 == jrt.n_threads
        got, want = rt.summarize_logs(paths), jrt.summarize_logs(paths)
    _same(got[0], want[0])
    _same(got[1], want[1])
    assert got[2] == want[2] == len(paths) - 1
    rt.close()                                  # closing twice is fine
    assert native.default_runtime() is native.default_runtime()
    assert native.default_runtime().n_threads == 4


@pytest.mark.parametrize("name", sorted(CSVS))
@pytest.mark.parametrize("skip_header", [True, False])
def test_scan_csv_columns_equals_jax(jnative, name, skip_header):
    text = CSVS[name].encode()
    got = native.scan_csv_columns(text, [0, 1, 2], skip_header=skip_header)
    want = jnative.scan_csv_columns(text, [0, 1, 2],
                                    skip_header=skip_header)
    _same(got, want)


def test_scan_csv_strtod_values():
    got = native.scan_csv_columns(CSVS["strtod"].encode(), [1])
    assert got[0].tolist() == [0.5, 16.0, 1.0, 2.0]


@pytest.mark.parametrize("name", sorted(JSONLS))
def test_scan_api_jsonl_equals_jax(jnative, name):
    text = JSONLS[name].encode()
    for g, w in zip(native.scan_api_jsonl(text), jnative.scan_api_jsonl(text)):
        _same(g, w)


TOKENS = ["INFO", "warn", "ERROR", "Exception", "exCEPtion", "debug",
          "2025-11-03 22:02:28", "2025-13-45 99:99:99", "1970-01-01T00:00:00",
          "\n", "\r\n", "\r", " ", "\x0c", "\u2028", ",", '"', '""', "0x10",
          "1_0", " 2", "0.5", "nan", "-inf", "1e400", "{}", "{",
          '"status_code": 200', '"latency_ms":', '"content_length": 9',
          " 1.5e3", "y" * 40, "é"]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.sampled_from(TOKENS), max_size=60))
def test_scanners_equal_jax_on_drawn_text(jnative, tokens):
    text = "".join(tokens).encode()
    for g, w in zip(native.scan_log(text), jnative.scan_log(text)):
        _same(g, w)
    _same(native.scan_csv_columns(text, [0, 2, 1]),
          jnative.scan_csv_columns(text, [0, 2, 1]))
    _same(native.scan_csv_columns(text, [3], skip_header=False),
          jnative.scan_csv_columns(text, [3], skip_header=False))
    for g, w in zip(native.scan_api_jsonl(text), jnative.scan_api_jsonl(text)):
        _same(g, w)


# -- the dispatch --------------------------------------------------------------

@pytest.mark.parametrize("setting", [None, "off"])
@pytest.mark.parametrize("name", sorted(set(LOGS) - {"bad_date"}))
def test_parse_log_lines_equals_jax(jnative, mode, setting, name):
    from anomod.io.logs import parse_log_lines as jparse
    from anomod_torch.io.logs import parse_log_lines
    mode(setting)
    for got, want in zip(parse_log_lines(LOGS[name], 3, 7.0),
                         jparse(LOGS[name], 3, 7.0)):
        _same(got, want)


@pytest.mark.parametrize("setting", [None, "off"])
def test_parse_log_lines_table_rows(jnative, mode, setting):
    from anomod.io.logs import parse_log_lines as jparse
    from anomod_torch.io.logs import parse_log_lines
    mode(setting)
    t = parse_log_lines(LOGS["epoch"], 0, 7.0)[1]
    assert t.tolist() == ([0.0] if setting == "off" else [7.0])
    if setting == "off":
        for fn in (parse_log_lines, jparse):
            with pytest.raises(ValueError):
                fn(LOGS["bad_date"], 0)
    else:
        got, want = parse_log_lines(LOGS["bad_date"], 0), \
            jparse(LOGS["bad_date"], 0)
        for g, w in zip(got, want):
            _same(g, w)
        assert got[1][0] > 1.7e9


@pytest.mark.parametrize("setting", [None, "off"])
def test_summarize_log_files_dispatch_equals_jax(jnative, mode, setting,
                                                 tmp_path):
    from anomod.io.logs import summarize_log_files as jsum
    from anomod_torch.io.logs import summarize_log_files
    mode(setting)
    paths = [p for p in _log_tree(tmp_path) if p.stem != "bad_date_0"]
    got = [dataclasses.astuple(s) for s in summarize_log_files(paths)]
    want = [dataclasses.astuple(s) for s in jsum(paths)]
    assert got == want
    lfs = got[[p.stem for p in paths].index("lfs_0")]
    assert lfs[1:] == ((0, 0, 0, 0, 0) if setting == "off"
                       else (3, 0, 0, 0, 128))
    if setting == "off":
        for fn in (summarize_log_files, jsum):
            with pytest.raises(ValueError):
                fn(_log_tree(tmp_path))


def _metric_fields(b):
    return (b.metric.tobytes(), b.series.tobytes(), b.t_s.tobytes(),
            b.value.tobytes(), b.metric_names, b.series_keys,
            b.series_service.tobytes(), b.services)


TT_HEAD = "metric_name,timestamp,datetime,value,pod\n"
TT_CSVS = {
    # the fast path holds: strtod's reading of the values
    "strtod": TT_HEAD + "cpu,1730671348,x,0.5,ts-a-1\ncpu,1730671363,x,0x10,"
    "ts-a-1\nmem,1730671348,x,1_0,ts-b-2\nmem,1730671363,x, 2,ts-b-2\n",
    # a quoted newline: the record count differs, the Python route
    "quoted_newline": TT_HEAD + 'cpu,1730671348,x,0.5,"ts-a\n1"\n'
    "cpu,1730671363,x,0x10,ts-a-1\n",
    # a date for a timestamp: the first-record check fails
    "date_stamp": TT_HEAD + "cpu,2024-11-03 22:02:28,x,0.5,ts-a-1\n"
    "cpu,1730671363,x,0x10,ts-a-1\n",
    # a later date is read as strtod reads it
    "late_date": TT_HEAD + "cpu,1730671348,x,0.5,ts-a-1\n"
    "cpu,2024-11-03 22:02:28,x,0x10,ts-a-1\n",
    "empty_value": TT_HEAD + "cpu,1730671348,x,,ts-a-1\ncpu,,x,nan,ts-a-1\n",
    "not_canonical": "timestamp,metric_name,datetime,value\n"
    "1730671348,cpu,x,0x10\n",
    "header_only": TT_HEAD,
}


@pytest.mark.parametrize("setting", [None, "off"])
@pytest.mark.parametrize("name", sorted(TT_CSVS))
def test_load_tt_metric_csv_equals_jax(jnative, mode, setting, name,
                                       tmp_path):
    from anomod.io.metrics import load_tt_metric_csv as jload
    from anomod_torch.io.metrics import load_tt_metric_csv
    mode(setting)
    p = tmp_path / "Lv_X_metrics_1.csv"
    p.write_text(TT_CSVS[name], newline="")
    got, want = load_tt_metric_csv(p), jload(p)
    if want is None:
        assert got is None
        return
    assert _metric_fields(got) == _metric_fields(want)
    if name == "strtod":
        np.testing.assert_array_equal(
            got.value, [0.5, 16.0, 1.0, 2.0] if setting is None
            else [0.5, np.nan, 10.0, 2.0])


@pytest.mark.parametrize("setting", [None, "off"])
def test_logscan_equals_jax(jnative, mode, setting, tmp_path, capsys):
    from anomod.cli import main as jmain
    from anomod_torch.cli import main
    mode(setting)
    for name in ("crlf", "form_feed", "exception_case", "levels_order"):
        (tmp_path / f"{name}_0.log").write_text(LOGS[name], newline="")
    (tmp_path / "stub_0.log").write_text(LFS_POINTER)
    assert main(["logscan", str(tmp_path)]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jmain(["logscan", str(tmp_path)]) == 0
    want = json.loads(capsys.readouterr().out)
    assert got == want
    assert got["native"] is (setting is None)


@pytest.mark.parametrize("setting", ["auto", "on", None])
def test_failed_build_raises(mode, setting, monkeypatch, tmp_path):
    from anomod_torch.io.logs import parse_log_lines, summarize_log_files
    mode(setting)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.enabled()
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        parse_log_lines("INFO\n", 0)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        summarize_log_files([tmp_path / "a.log"])
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.scan_log(b"INFO\n")
    mode("off")
    assert native.enabled() is False
    assert parse_log_lines("INFO\n", 0)[2].tolist() == [0]


# -- the sanitizer smoke ---------------------------------------------------------

def test_sanitize_smoke_verdict_shapes():
    """The probe gives a reasoned verdict either way; a box with no
    compiler skips with its reason."""
    from anomod_torch.io import sanitize
    p = sanitize.probe("tsan")
    assert set(p) == {"ok", "reason"}
    assert p["ok"] is True or p["reason"]
    with pytest.raises(ValueError):
        sanitize.run("nope")
    missing = sanitize.probe("tsan", cxx="definitely-not-a-compiler")
    assert missing["ok"] is False and "compiler" in missing["reason"]
    out = sanitize.run("asan", cxx="definitely-not-a-compiler")
    assert out == {"check": "native_sanitize_smoke", "sanitizer": "asan",
                   "status": "skip", "reason": missing["reason"]}


@pytest.mark.slow
@pytest.mark.parametrize("leg", ["tsan", "asan"])
def test_sanitize_smoke_full_run(leg):
    from anomod_torch.io import sanitize
    out = sanitize.run(leg, workers=2, iters=8)
    assert out["status"] in ("ok", "skip"), out
    if out["status"] == "ok":
        assert out["exit_code"] == 0


# -- chip_smoke.py phase 30 at a small size ---------------------------------------

SMALL_CORPUS = dict(log_files=4, lines_per_service=120, metric_duration_s=150,
                    api_records=500)


def test_phase30_outputs_equal_jax_and_python(jnative, mode, tmp_path):
    """Phase 30's corpus and outputs at a small size: the port's native
    outputs == the JAX package's, byte for byte, and == the Python
    routes'; the digest table names every output."""
    import anomod
    import anomod_torch
    import chip_smoke
    from anomod_torch import config
    from anomod_torch.io import logs, metrics
    corpus = chip_smoke.native_scan_corpus(tmp_path / "a", SMALL_CORPUS)
    again = chip_smoke.native_scan_corpus(tmp_path / "b", SMALL_CORPUS)
    assert len(corpus["logs"]) == SMALL_CORPUS["log_files"]
    assert chip_smoke.corpus_digests(corpus) == \
        chip_smoke.corpus_digests(again)
    walls = {}
    got = chip_smoke.native_scan_outputs(anomod_torch, corpus, walls)
    want = chip_smoke.native_scan_outputs(anomod, corpus)
    assert got == want and set(walls) == set(got) - {
        "runtime_summarize_logs"}
    py = chip_smoke.python_scan_outputs(corpus, {})
    with chip_smoke.package_env(config, {"ANOMOD_NATIVE": "off"}):
        py.update(chip_smoke.parser_outputs(logs, metrics, corpus))
    assert {k: got[k] == v for k, v in py.items()} == dict.fromkeys(py, True)
    assert set(chip_smoke.NATIVE_SCAN_DIGESTS) == \
        set(chip_smoke.corpus_digests(corpus)) | set(got)
