"""The collectors' fetch transport and its fault seat ``http.fetch``: a
port of ``tse1m_tpu/collect/transport.py``.

The reference configures ``requests`` retry adapters per script
(``2_get_buildlog_metadata.py:106-108``: total=5, backoff 1, on
502/503/504; ``3_get_coverage_data.py:73-74``: total=3, backoff 0.5, on
5xx) and treats a 404 as "no report today" (``3_…py:79-80``).  Here that
policy is one dataclass, :class:`FetchPolicy`, and the transport is a
protocol, so every collector runs against a directory of recorded pages
(:class:`DirFetcher`) as well as the network (:class:`HttpFetcher`).

:class:`HttpFetcher` keeps the JAX package's seam: ``session=`` is any
object with ``.get(url, params=, timeout=)`` returning something with
``status_code``, ``content``, ``headers`` and ``raise_for_status()``.  Its
default session, :class:`UrllibSession`, is a small adapter over
``urllib.request`` (the card's machine has no ``requests``): urllib
raises ``HTTPError`` for every status of 400 or more, and the adapter
turns it back into a response, so a 404 is ``None``, a 429 or 503 is
retried after its ``Retry-After`` and any other 4xx is not retried.
Timeouts and ``URLError`` are connection errors, and they are retried.
"""

from __future__ import annotations

import email.utils
import json
import logging
import os
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Protocol

from ..resilience.faults import fault_point
from ..utils.retry import RetryError, RetryPolicy, retry_call

log = logging.getLogger("tse1m_tpu_torch.collect.transport")


@dataclass(frozen=True)
class FetchPolicy:
    """Retry, backoff and politeness policy of a real transport."""

    retries: int = 3
    backoff_factor: float = 0.5
    retry_statuses: tuple = (429, 500, 502, 503, 504)
    timeout: float = 10.0
    # Fixed sleep between successive requests: the reference sleeps 0.5 s
    # per coverage page (3_get_coverage_data.py:135) and 5 s per GCS page
    # (2_get_buildlog_metadata.py:100,152).
    politeness_delay: float = 0.0
    # Budget over all attempts of one get(), and the cap on a server's
    # Retry-After hint.  None: bounded by the attempts only.
    deadline: float | None = None


@dataclass
class Response:
    url: str
    status: int
    content: bytes

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")

    def json(self):
        return json.loads(self.text)


class Fetcher(Protocol):
    def get(self, url: str, params: dict | None = None) -> Response | None:
        """Fetch a URL: None for a 404 (an absent resource, a normal
        outcome for daily reports); raises on a persistent failure."""
        ...


class FetchError(RuntimeError):
    """A request failed after the retry budget.  ``retry_after``
    (seconds) carries a server's ``Retry-After`` hint for a 429 or 503;
    the retry engine raises its next sleep to at least that."""

    def __init__(self, message: str, retry_after: float | None = None):
        super().__init__(message)
        self.retry_after = retry_after


class HTTPStatusError(RuntimeError):
    """``raise_for_status`` of :class:`UrllibSession`'s responses."""


def parse_retry_after(value) -> float | None:
    """A ``Retry-After`` header in seconds (its number or HTTP-date
    form), None when absent or unreadable; negative values clamp to 0."""
    if value is None:
        return None
    s = str(value).strip()
    if not s:
        return None
    try:
        return max(0.0, float(s))
    except ValueError:
        pass
    try:
        dt = email.utils.parsedate_to_datetime(s)
    except (TypeError, ValueError):
        return None
    if dt is None:
        return None
    import datetime as _dt

    now = _dt.datetime.now(_dt.timezone.utc)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return max(0.0, (dt - now).total_seconds())


# Without a policy deadline a server's Retry-After still cannot stall a
# collector indefinitely.
_RETRY_AFTER_CAP = 60.0


def _with_params(url: str, params: dict | None) -> str:
    if not params:
        return url
    sep = "&" if "?" in url else "?"
    return url + sep + urllib.parse.urlencode(sorted(params.items()))


class _UrllibResponse:
    def __init__(self, url: str, status: int, content: bytes, headers):
        self.url = url
        self.status_code = status
        self.content = content
        self.headers = headers if headers is not None else {}

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            raise HTTPStatusError(f"HTTP {self.status_code} for {self.url}")


class UrllibSession:
    """The default session of :class:`HttpFetcher`: one GET through
    ``urllib.request``.  Parameters are encoded in the caller's order, as
    ``requests`` encodes them."""

    def __init__(self, user_agent: str = "tse1m-collect/1.0"):
        self.user_agent = user_agent

    def get(self, url: str, params: dict | None = None,
            timeout: float | None = None) -> _UrllibResponse:
        if params:
            url += ("&" if "?" in url else "?") + urllib.parse.urlencode(
                list(params.items()))
        req = urllib.request.Request(url,
                                     headers={"User-Agent": self.user_agent})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return _UrllibResponse(url, r.status, r.read(), r.headers)
        except urllib.error.HTTPError as e:
            # urllib raises for every status >= 400; HttpFetcher decides
            # what each one means.
            body = e.read() if e.fp is not None else b""
            return _UrllibResponse(url, e.code, body, e.headers)
        except (urllib.error.URLError, socket.timeout, TimeoutError) as e:
            raise ConnectionError(f"GET {url}: {e}") from e


class HttpFetcher:
    """A network transport with the shared retry policy.  The politeness
    pause is serialized, so threads sharing one fetcher (the build-log
    analyzer's workers) keep the promised aggregate request rate."""

    def __init__(self, policy: FetchPolicy | None = None, session=None):
        self.policy = policy or FetchPolicy()
        self.session = session if session is not None else UrllibSession()
        self._last_request_t = 0.0
        self._pause_lock = threading.Lock()

    def _politeness_pause(self) -> None:
        delay = self.policy.politeness_delay
        with self._pause_lock:
            if delay > 0:
                elapsed = time.monotonic() - self._last_request_t
                if elapsed < delay:
                    time.sleep(delay - elapsed)
            self._last_request_t = time.monotonic()

    def get(self, url: str, params: dict | None = None) -> Response | None:
        p = self.policy

        def attempt() -> Response | None:
            fault_point("http.fetch")
            self._politeness_pause()
            r = self.session.get(url, params=params, timeout=p.timeout)
            if r.status_code == 404:
                return None
            if r.status_code in p.retry_statuses:
                # 429/503 servers often say when to come back: honour it,
                # capped at the policy deadline (or a sane bound).
                hint = parse_retry_after(
                    getattr(r, "headers", {}).get("Retry-After"))
                if hint is not None:
                    hint = min(hint, p.deadline if p.deadline is not None
                               else _RETRY_AFTER_CAP)
                raise FetchError(f"HTTP {r.status_code} for {url}",
                                 retry_after=hint)
            try:
                r.raise_for_status()
            except Exception as e:
                e.no_retry = True  # a hard 4xx: retrying cannot help
                raise
            return Response(url=url, status=r.status_code, content=r.content)

        try:
            return retry_call(
                attempt,
                policy=RetryPolicy(max_attempts=p.retries + 1,
                                   base_delay=p.backoff_factor,
                                   deadline=p.deadline),
                site=f"http.fetch {url}",
                should_retry=lambda e: not getattr(e, "no_retry", False))
        except RetryError as e:
            raise FetchError(
                f"giving up on {url} after {e.attempts} attempts"
            ) from e.__cause__


class DirFetcher:
    """A directory of recorded pages, for tests and offline replay.

    URL ``scheme://host/path?query`` maps to ``root/host/path``, with the
    query string (if any) appended as ``#<urlencoded-query>``.  A missing
    file is a 404 (None)."""

    def __init__(self, root: str):
        self.root = root
        self.requests: list[str] = []

    def path_for(self, url: str, params: dict | None = None) -> str:
        full = _with_params(url, params)
        self.requests.append(full)
        rest = full.split("://", 1)[-1]
        if "?" in rest:
            rest, query = rest.split("?", 1)
            rest = rest.rstrip("/") + "#" + urllib.parse.quote(query,
                                                               safe="=&")
        return os.path.join(self.root, *rest.split("/"))

    def get(self, url: str, params: dict | None = None) -> Response | None:
        path = self.path_for(url, params)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return Response(url=url, status=200, content=f.read())


__all__ = ["DirFetcher", "FetchError", "FetchPolicy", "Fetcher",
           "HTTPStatusError", "HttpFetcher", "Response", "UrllibSession",
           "parse_retry_after"]
