"""The Selenium-backed :class:`~.issues.IssuePageClient`: a port of
``tse1m_tpu/collect/issues_selenium.py``.

Captures the live tracker's Angular DOM into the structured
:class:`RawIssuePage` the pure parsers consume.  Selectors follow the
reference (``5_get_issue_reports.py:127-291``): ``b-issue-details`` /
``edit-issue-metadata`` as load sentinels, throttle detection via the
"Request throttled" snackbar, metadata out of ``edit-issue-metadata``
field containers, events from ``issue-event-list``, and the shadow-DOM
``revisions-info`` table on revision sub-pages.

This module imports selenium only inside its methods, as the JAX
package's does: the rest of the collection layer never touches it, and
the card's machine, which has no selenium, raises ImportError only when
a client is made (``collect issues`` with a non-empty plan).  It cannot be exercised offline; its
logic floor is kept deliberately thin, with everything parseable pushed
into :mod:`.issues`.
"""

from __future__ import annotations

import logging
import time

from .issues import (IssueEvent, RawIssuePage, RevisionTable, issue_url,
                     revision_buildtime_from_url, split_revision_range)

log = logging.getLogger("tse1m_tpu_torch.collect.issues.selenium")

METADATA_LABELS = ("Reporter", "Type", "Priority", "Severity", "Status",
                   "Assignee", "Verifier", "Collaborators", "CC", "Project",
                   "Disclosure", "Reported", "Code Changes",
                   "Pending Code Changes", "Staffing", "Found In",
                   "Targeted To", "Verified In")
USER_LABELS = ("Reporter", "Assignee", "Verifier", "Collaborators", "CC")


class SeleniumIssueClient:
    """One headless Chrome per client instance (one per worker window)."""

    def __init__(self, load_timeout: int = 20, max_retries: int = 5,
                 throttle_wait: float = 10.0, page_delay: tuple = (1.0, 3.0)):
        from selenium import webdriver

        options = webdriver.ChromeOptions()
        for arg in ("--headless", "--disable-gpu", "--no-sandbox",
                    "--disable-dev-shm-usage",
                    "--blink-settings=imagesEnabled=false"):
            options.add_argument(arg)
        self.driver = webdriver.Chrome(options=options)
        self.load_timeout = load_timeout
        self.max_retries = max_retries
        self.throttle_wait = throttle_wait
        self.page_delay = page_delay

    def close(self) -> None:
        try:
            self.driver.quit()
        except Exception:  # graftlint: disable=broad-except -- best-effort driver teardown; no fault seat fires inside quit()
            pass

    # -- helpers ------------------------------------------------------------

    def _wait(self, timeout=None):
        from selenium.webdriver.support.ui import WebDriverWait

        return WebDriverWait(self.driver, timeout or self.load_timeout)

    def _throttled(self) -> bool:
        from selenium.common.exceptions import NoSuchElementException
        from selenium.webdriver.common.by import By

        try:
            el = self.driver.find_element(
                By.XPATH, "//*[contains(@class, 'snackbar-content') and "
                          "contains(., 'Request throttled')]")
            return el.is_displayed()
        except NoSuchElementException:
            return False

    # -- IssuePageClient ----------------------------------------------------

    def fetch_issue(self, issue_no: int) -> RawIssuePage:
        import random

        from selenium.common.exceptions import (NoSuchElementException,
                                                TimeoutException)
        from selenium.webdriver.common.by import By
        from selenium.webdriver.support import expected_conditions as EC

        url = issue_url(issue_no)
        loaded = False
        for attempt in range(self.max_retries):
            self.driver.get(url)
            try:
                self._wait().until(EC.presence_of_element_located(
                    (By.CSS_SELECTOR, "b-issue-details, edit-issue-metadata")))
                loaded = True
                break
            except TimeoutException:
                if self._throttled():
                    log.info("throttled on %s; waiting %.0fs", issue_no,
                             self.throttle_wait)
                    time.sleep(self.throttle_wait)
                    continue
                log.info("load timeout for %s (attempt %d/%d)", issue_no,
                         attempt + 1, self.max_retries)
        if not loaded:
            return RawIssuePage(final_id=str(issue_no), url=url,
                                load_error=True)
        time.sleep(1)
        page = RawIssuePage(final_id=self.driver.current_url.split("/")[-1],
                            url=self.driver.current_url)

        for selector in ("h3.heading-m.ng-star-inserted", "issue-header h3"):
            try:
                page.title = self.driver.find_element(
                    By.CSS_SELECTOR, selector).text
                break
            except NoSuchElementException:
                continue
        else:
            page.load_error = True

        try:
            page.hotlists = [el.text for el in self.driver.find_elements(
                By.CSS_SELECTOR, "b-hotlist-chip-smart span.name a")
                if el.text]
        except Exception:  # graftlint: disable=broad-except -- optional hotlist-chip scrape; the driver raises arbitrary exceptions and no fault seat fires inside
            pass

        try:
            el = self._wait(10).until(EC.presence_of_element_located(
                (By.CSS_SELECTOR, "b-formatted-date-time time")))
            page.reported_time_iso = el.get_attribute("datetime")
        except TimeoutException:
            pass

        page.metadata = self._scrape_metadata()
        page.events = self._scrape_events()
        try:
            page.description = self._wait(10).until(
                EC.presence_of_element_located(
                    (By.TAG_NAME, "b-issue-description"))).text
        except TimeoutException:
            log.info("no description container for %s", page.final_id)

        time.sleep(random.uniform(*self.page_delay))  # graftlint: disable=nondeterminism -- human-like page pacing against the live tracker; scrape cadence is deliberately not replayable
        return page

    def _scrape_metadata(self) -> dict:
        from selenium.common.exceptions import (NoSuchElementException,
                                                TimeoutException)
        from selenium.webdriver.common.by import By
        from selenium.webdriver.support import expected_conditions as EC

        out: dict = {}
        try:
            container = self._wait(10).until(EC.presence_of_element_located(
                (By.TAG_NAME, "edit-issue-metadata")))
        except TimeoutException:
            return out
        fields = container.find_elements(
            By.CSS_SELECTOR, "b-edit-field, b-multi-user-control, "
                             "b-staffing-row")
        for field in fields:
            try:
                label = field.find_element(By.TAG_NAME, "label").text.strip()
                if label not in METADATA_LABELS:
                    continue
                if label in USER_LABELS:
                    values = [v.text.strip() for v in field.find_elements(
                        By.TAG_NAME, "b-person-hovercard")
                        if v.text.strip() and v.text.strip() != "--"]
                    if not values:
                        out[label] = None
                    elif label in ("CC", "Collaborators"):
                        out[label] = values
                    else:
                        out[label] = values[0] if len(values) == 1 else values
                else:
                    value = field.find_element(
                        By.CSS_SELECTOR, ".bv2-metadata-field-value, "
                                         ".staffing-summaries, .no-value"
                    ).text.strip()
                    out[label] = None if value in ("--", "") else value
            except NoSuchElementException:
                continue
        return out

    def _scrape_events(self) -> list:
        from selenium.common.exceptions import (NoSuchElementException,
                                                TimeoutException)
        from selenium.webdriver.common.by import By
        from selenium.webdriver.support import expected_conditions as EC

        events: list = []
        try:
            container = self._wait(10).until(EC.presence_of_element_located(
                (By.TAG_NAME, "issue-event-list")))
        except TimeoutException:
            return events
        for event in container.find_elements(By.CSS_SELECTOR, "div.bv2-event"):
            try:
                section = event.find_element(
                    By.CSS_SELECTOR, "b-plain-format-unquoted-section, "
                                     "b-markdown-format-presenter")
            except NoSuchElementException:
                continue
            time_iso = None
            try:
                time_iso = event.find_element(
                    By.CSS_SELECTOR, "h4 b-formatted-date-time time"
                ).get_attribute("datetime")
            except NoSuchElementException:
                pass
            links = [a.get_attribute("href") for a in event.find_elements(
                By.CSS_SELECTOR, 'a[href*="/revisions"]')]
            events.append(IssueEvent(text=section.text, time_iso=time_iso,
                                     revision_links=links))
        return events

    def fetch_revisions(self, url: str) -> RevisionTable | None:
        from selenium.common.exceptions import (NoSuchElementException,
                                                TimeoutException)
        from selenium.webdriver.common.by import By
        from selenium.webdriver.support import expected_conditions as EC

        original = self.driver.current_url
        for attempt in range(3):
            try:
                self.driver.get(url)
                self._wait(15).until(
                    lambda d: d.current_url != original
                    and "about:blank" not in d.current_url)
                break
            except TimeoutException:
                log.info("revision page stuck; retry %d/3", attempt + 1)
        else:
            self.driver.get(original)
            return None

        try:
            if self.driver.find_element(
                    By.XPATH, "//*[contains(text(), 'Failed to get component "
                              "revisions.')]").is_displayed():
                return None
        except NoSuchElementException:
            pass

        components: list = []
        revisions: list = []
        try:
            host = self._wait(10).until(EC.presence_of_element_located(
                (By.TAG_NAME, "revisions-info")))
            self._wait(10).until(lambda d: host.shadow_root.find_elements(
                By.CSS_SELECTOR, "table tr.body"))
            time.sleep(1)  # let the JS table settle (5_…py:94)
            for row in host.shadow_root.find_elements(
                    By.CSS_SELECTOR, "table tr.body"):
                cells = row.find_elements(By.TAG_NAME, "td")
                if len(cells) >= 2:
                    comp = cells[0].text.strip()
                    rev = cells[1].text.strip()
                    if comp and rev:
                        components.append(comp)
                        revisions.append(split_revision_range(rev))
        except (TimeoutException, NoSuchElementException):
            log.info("revision table missing at %s", url)
        finally:
            if self.driver.current_url != original:
                self.driver.get(original)
        return RevisionTable(components=components, revisions=revisions,
                             buildtime=revision_buildtime_from_url(url))


__all__ = ["METADATA_LABELS", "SeleniumIssueClient", "USER_LABELS"]
