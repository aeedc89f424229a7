"""The port's SeleniumIssueClient against the JAX package's, over the fake
webdriver and DOM of tests/test_issues_selenium.py (imported, not
copied): every path of the client runs in both packages on the same
pages and must give the same captures and navigations.  selenium itself
is never imported when the port's module is."""

from __future__ import annotations

import subprocess
import sys

import pytest

from tests.test_issues_selenium import (REV_URL, FakeDriver, FakeElement,
                                        fake_selenium, loaded_issue_page,
                                        throttled_page)

assert fake_selenium  # the fixture, used by name below

PKGS = ("tse1m_tpu.collect.issues_selenium",
        "tse1m_tpu_torch.collect.issues_selenium")


def _client(fake, module, **kw):
    import importlib

    driver = FakeDriver()
    fake["driver"] = driver
    kw.setdefault("page_delay", (0, 0))
    return importlib.import_module(module).SeleniumIssueClient(**kw), driver


def _capture(page) -> dict:
    d = dict(vars(page))
    d["events"] = [vars(e) for e in page.events]
    return d


def test_fetch_issue_happy_path_as_jax(fake_selenium):
    out = []
    for module in PKGS:
        client, driver = _client(fake_selenium, module)
        url = "https://issues.oss-fuzz.com/issues/42000000"
        driver.add_route(url, loaded_issue_page(),
                         final_url="https://issues.oss-fuzz.com/issues/"
                                   "42000001")
        page = client.fetch_issue(42_000_000)
        client.close()
        assert driver.quit_called and not page.load_error
        out.append((_capture(page), driver.navigations))
    assert out[1] == out[0]
    assert out[1][0]["final_id"] == "42000001"
    assert out[1][0]["metadata"]["CC"] == ["a@chromium.org",
                                           "b@chromium.org"]


def test_fetch_issue_throttled_and_load_failure_as_jax(fake_selenium):
    out = []
    for module in PKGS:
        client, driver = _client(fake_selenium, module, throttle_wait=0.0,
                                 max_retries=3)
        url = "https://issues.oss-fuzz.com/issues/42000000"
        driver.add_route(url, throttled_page(), once=True)
        driver.add_route(url, loaded_issue_page())
        ok = client.fetch_issue(42_000_000)
        client2, driver2 = _client(fake_selenium, module, max_retries=2)
        failed = client2.fetch_issue(42_000_000)
        out.append((_capture(ok), driver.navigations, _capture(failed),
                    driver2.navigations))
    assert out[1] == out[0]
    assert out[1][1].count("https://issues.oss-fuzz.com/issues/42000000") \
        == 2
    assert out[1][2]["load_error"] and len(out[1][3]) == 2


def _rev_page():
    long_a, long_b = "a" * 40, "b" * 40
    shadow = FakeElement("shadow", children=[
        FakeElement("table", children=[
            FakeElement("tr", classes={"body"}, children=[
                FakeElement("td", text="zlib"),
                FakeElement("td", text=f"{long_a}:{long_b}")]),
            FakeElement("tr", classes={"body"}, children=[
                FakeElement("td", text="afl"), FakeElement("td",
                                                           text="v1.2")]),
            FakeElement("tr", classes={"body"}, children=[
                FakeElement("td", text="short-row")])])])
    return FakeElement("html", children=[
        FakeElement("revisions-info", shadow=shadow)])


@pytest.mark.parametrize("kind", ["table", "failed", "stuck"])
def test_fetch_revisions_as_jax(fake_selenium, kind):
    out = []
    for module in PKGS:
        client, driver = _client(fake_selenium, module)
        origin = "https://issues.oss-fuzz.com/issues/42000001"
        driver.add_route(origin, loaded_issue_page())
        driver.get(origin)
        if kind == "table":
            driver.add_route(REV_URL, _rev_page())
        elif kind == "failed":
            driver.add_route(REV_URL, FakeElement("html", children=[
                FakeElement("div",
                            text="Failed to get component revisions.")]))
        else:  # the revision page never leaves the origin
            driver.add_route(REV_URL, loaded_issue_page(), final_url=origin)
        table = client.fetch_revisions(REV_URL)
        out.append((None if table is None else vars(table),
                    driver.navigations, driver.current_url))
    assert out[1] == out[0]
    if kind == "table":
        assert out[1][0]["revisions"] == [["a" * 40, "b" * 40], ["v1.2"]]
        assert out[1][0]["buildtime"] == ["1700", "1800"]
    else:
        assert out[1][0] is None


def test_port_module_imports_without_selenium():
    """On the card's machine there is no selenium: the module imports,
    and only making a client raises JAX's ImportError."""
    code = ("import sys\nsys.modules['selenium'] = None\n"
            "from tse1m_tpu_torch.collect import issues_selenium as m\n"
            "try:\n    m.SeleniumIssueClient()\n"
            "except ImportError as e:\n    print('ImportError', e)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("ImportError")
