"""Workload-suite helpers — analogs of the EvoMaster test utilities and the
wrk2 mixed-workload content model.

Counterpart of ``anomod/workload.py``: the same host code (no device, no
CUDA), held to it by ``tests/test_torch_workload.py``.

- ``resolve_location``: merge a ``Location`` response header against a URI
  template, the behavior of the reference's generated-suite helper
  (BlackBox_tests/Final_version_2m/em_test_utils.py:4-26) re-implemented
  fresh on urllib.
- ``is_valid_uri_or_empty``: permissive URI syntax check
  (em_test_utils.py:27-46 uses rfc3986; this uses urllib splitting).
- ``SN_REQUEST_MIX``: the wrk2 workload distribution
  (mixed-workload.lua:113-115 — 60% home-timeline read, 30% user-timeline
  read, 10% compose), used by the synthetic generator's SN template
  weighting.
- wrk2 *content model* (``compose_post_body``, ``timeline_query``,
  ``sample_wrk2_request``): the reference's request-body synthesis
  (mixed-workload.lua:33-108) as deterministic numpy-seeded draws, so
  generated ``api_responses.jsonl`` artifacts carry the same
  method/content-length distributions as real wrk2 traffic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
from urllib.parse import urlparse, urlunparse

# mixed-workload.lua:113-115
SN_REQUEST_MIX = {
    "home-timeline-service": 0.60,
    "user-timeline-service": 0.30,
    "compose-post-service": 0.10,
}

# ---------------------------------------------------------------------------
# wrk2 content-model parameters (mixed-workload.lua).  Lua's `for i = 0, n`
# loop body runs n+1 times, so the drawn `math.random(0, 5)` mention/url
# counts yield 1..6 appended items (and media 1..5) — the model reproduces
# that off-by-one because it is what the real workload sends.
# ---------------------------------------------------------------------------
WRK2_CHARSET = ("qwertyuiopasdfghjklzxcvbnm"
                "QWERTYUIOPASDFGHJKLZXCVBNM1234567890")   # :7-10
WRK2_MAX_USER_INDEX = 962       # :15 (env default)
WRK2_TEXT_LEN = 256             # :37 stringRandom(256)
WRK2_MENTION_RANGE = (1, 6)     # :38 math.random(0,5), loop 0..n
WRK2_URL_RANGE = (1, 6)         # :39
WRK2_MEDIA_RANGE = (1, 5)       # :40 math.random(0,4), loop 0..n
WRK2_URL_LEN = 64               # :56 " http://" .. stringRandom(64)
WRK2_MEDIA_ID_LEN = 18          # :60 decRandom(18)
WRK2_TIMELINE_STOP_OFFSET = 10  # :86-88 stop = start + 10
WRK2_TIMELINE_START_MAX = 100   # :85 math.random(0, 100)

_MENTION_PREFIX = " @username_"  # :52
_URL_PREFIX = " http://"         # :56

# Byte-length decomposition shared by the analytic bounds and the vectorized
# sampler (kept in one place so they can't drift from compose_post_body).
_FORM_OVERHEAD = len("username=username_&user_id=&text=&media_ids="
                     "&media_types=&post_type=0")
_PNG_LEN = len('"png"')


def _media_lists_len(k):
    """len(media_ids) + len(media_types) for ``k`` media entries: each is
    '[' + k quoted items + (k-1) commas + ']'.  Works elementwise on numpy
    arrays."""
    return (2 + k * (WRK2_MEDIA_ID_LEN + 2) + (k - 1)) \
        + (2 + k * _PNG_LEN + (k - 1))


def _text_len(m, mention_digits, u):
    """len(text): base + mentions + urls; elementwise-safe."""
    return (WRK2_TEXT_LEN
            + m * len(_MENTION_PREFIX) + mention_digits
            + u * (len(_URL_PREFIX) + WRK2_URL_LEN))


def _rand_string(rng: np.random.Generator, length: int,
                 charset: str = WRK2_CHARSET) -> str:
    return "".join(charset[i] for i in
                   rng.integers(0, len(charset), length))


def compose_post_body(rng: np.random.Generator) -> str:
    """One compose-post form body with the reference's exact content model
    (mixed-workload.lua:33-83): 256-char base text, 1-6 ``@username_<id>``
    mentions (never self), 1-6 64-char urls, 1-5 18-digit media ids typed
    ``png``, form-urlencoded field layout with the JSON-ish bracket lists."""
    user_index = int(rng.integers(0, WRK2_MAX_USER_INDEX))
    text = _rand_string(rng, WRK2_TEXT_LEN)
    n_mentions = int(rng.integers(WRK2_MENTION_RANGE[0],
                                  WRK2_MENTION_RANGE[1] + 1))
    n_urls = int(rng.integers(WRK2_URL_RANGE[0], WRK2_URL_RANGE[1] + 1))
    n_media = int(rng.integers(WRK2_MEDIA_RANGE[0], WRK2_MEDIA_RANGE[1] + 1))
    for _ in range(n_mentions):
        while True:
            mention = int(rng.integers(0, WRK2_MAX_USER_INDEX))
            if mention != user_index:
                break
        text += f"{_MENTION_PREFIX}{mention}"
    for _ in range(n_urls):
        text += _URL_PREFIX + _rand_string(rng, WRK2_URL_LEN)
    media_ids = "[" + ",".join(
        '"' + _rand_string(rng, WRK2_MEDIA_ID_LEN, "1234567890") + '"'
        for _ in range(n_media)) + "]"
    media_types = "[" + ",".join('"png"' for _ in range(n_media)) + "]"
    return (f"username=username_{user_index}&user_id={user_index}"
            f"&text={text}&media_ids={media_ids}"
            f"&media_types={media_types}&post_type=0")


def timeline_query(rng: np.random.Generator) -> str:
    """Timeline-read query args (mixed-workload.lua:84-108):
    ``user_id`` uniform over the seeded graph, ``stop = start + 10``."""
    user_id = int(rng.integers(0, WRK2_MAX_USER_INDEX))
    start = int(rng.integers(0, WRK2_TIMELINE_START_MAX + 1))
    return f"user_id={user_id}&start={start}&stop={start + WRK2_TIMELINE_STOP_OFFSET}"


@dataclasses.dataclass(frozen=True)
class WorkloadRequest:
    """One synthesized wrk2 request (wrk.format analog)."""
    method: str
    path: str        # path + query, gateway-relative
    template: str    # canonical endpoint path
    body: Optional[str] = None

    @property
    def content_length(self) -> int:
        return len(self.body) if self.body is not None else 0


def sample_wrk2_request(rng: np.random.Generator) -> WorkloadRequest:
    """Draw one request from the 60/30/10 mix with full content synthesis
    (mixed-workload.lua:111-125)."""
    coin = float(rng.random())
    if coin < SN_REQUEST_MIX["home-timeline-service"]:
        tpl = "/wrk2-api/home-timeline/read"
        return WorkloadRequest("GET", f"{tpl}?{timeline_query(rng)}", tpl)
    if coin < (SN_REQUEST_MIX["home-timeline-service"]
               + SN_REQUEST_MIX["user-timeline-service"]):
        tpl = "/wrk2-api/user-timeline/read"
        return WorkloadRequest("GET", f"{tpl}?{timeline_query(rng)}", tpl)
    tpl = "/wrk2-api/post/compose"
    return WorkloadRequest("POST", tpl, tpl, body=compose_post_body(rng))


def compose_length_bounds() -> Tuple[int, int]:
    """Analytic (min, max) compose-body length implied by the lua
    parameters — used by tests and the synthetic generator to validate
    sampled content-length histograms."""
    def total(idx_d: int, m: int, mention_d: int, u: int, k: int) -> int:
        return (_FORM_OVERHEAD + 2 * idx_d
                + _text_len(m, m * mention_d, u) + _media_lists_len(k))

    lo = total(1, WRK2_MENTION_RANGE[0], 1, WRK2_URL_RANGE[0],
               WRK2_MEDIA_RANGE[0])
    hi = total(3, WRK2_MENTION_RANGE[1], 3, WRK2_URL_RANGE[1],
               WRK2_MEDIA_RANGE[1])
    return lo, hi


def sample_compose_lengths(rng: np.random.Generator, n: int) -> np.ndarray:
    """Vectorized draw of ``n`` compose content-lengths from the analytic
    length decomposition (same distribution as ``len(compose_post_body)``
    without string materialization — used for bulk synthesis)."""
    idx = rng.integers(0, WRK2_MAX_USER_INDEX, n)
    idx_d = np.char.str_len(idx.astype(str))
    m = rng.integers(WRK2_MENTION_RANGE[0], WRK2_MENTION_RANGE[1] + 1, n)
    # per-mention id digit counts: draw all at max fan-out and mask
    mention_ids = rng.integers(0, WRK2_MAX_USER_INDEX,
                               (n, WRK2_MENTION_RANGE[1]))
    mention_d = np.char.str_len(mention_ids.astype(str))
    mask = np.arange(WRK2_MENTION_RANGE[1])[None, :] < m[:, None]
    mention_digits = (mention_d * mask).sum(axis=1)
    u = rng.integers(WRK2_URL_RANGE[0], WRK2_URL_RANGE[1] + 1, n)
    k = rng.integers(WRK2_MEDIA_RANGE[0], WRK2_MEDIA_RANGE[1] + 1, n)
    return (_FORM_OVERHEAD + 2 * idx_d
            + _text_len(m, mention_digits, u)
            + _media_lists_len(k)).astype(np.int32)


def resolve_location(location_header: str, expected_template: str) -> str:
    """Resolve a Location header against the URI template of the followed-up
    endpoint: absolute locations win; relative ones adopt the template's
    scheme/authority; an empty location falls back to the template."""
    if not location_header:
        return expected_template
    loc = urlparse(location_header)
    if loc.scheme and loc.netloc:
        return location_header
    tpl = urlparse(expected_template)
    path = location_header if location_header.startswith("/") else \
        "/" + location_header
    return urlunparse((tpl.scheme, tpl.netloc, path, "", loc.query, ""))


def is_valid_uri_or_empty(uri: str) -> bool:
    """True for "" or a syntactically plausible absolute/relative URI."""
    if uri == "":
        return True
    try:
        parsed = urlparse(uri)
    except ValueError:
        return False
    if parsed.scheme and not parsed.netloc and not parsed.path:
        return False
    # reject whitespace and control characters anywhere
    return not any(c.isspace() or ord(c) < 32 for c in uri)
