"""C8's collection half, the seed-corpus archaeology (reference:
``user_corpus.py:39-240``): a port of ``tse1m_tpu/collect/corpus.py``.

Per project in an oss-fuzz checkout:

- project creation time: first commit that *added* files under
  ``projects/<name>`` (``git log --reverse --diff-filter=A``,
  user_corpus.py:178-179);
- corpus introduction: first commit whose ``build.sh`` change mentions
  ``_seed_corpus.zip`` (``git log -S``, user_corpus.py:189-190), plus that
  commit's PR merge time via the GitHub API (user_corpus.py:102-154) when a
  token/transport is available;
- elapsed seconds for both, feeding the RQ4 grouping (the *analysis* half
  lives in ``analysis/corpus.py``).

Output: ``project_corpus_analysis.csv`` with the reference's 7 columns
(user_corpus.py:225-233), written through ``collect/table.py`` as the JAX
package's ``DataFrame.to_csv`` writes it.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from datetime import datetime

from . import table
from .projects import run_git
from .transport import Fetcher

log = logging.getLogger("tse1m_tpu_torch.collect.corpus")

SEED_CORPUS_NEEDLE = "_seed_corpus.zip"
GITHUB_API = "https://api.github.com/repos/{owner}/{repo}"

CSV_HEADER = ["project_name", "is_Corpus", "corpus_commit_time",
              "corpus_merged_time", "project_creation_time",
              "time_elapsed_seconds", "merged_time_elapsed_seconds"]


def _parse_iso(s: str | None) -> datetime | None:
    if not s:
        return None
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    try:
        return datetime.fromisoformat(s)
    except ValueError:
        return None


def project_creation_time(repo_path: str, project: str) -> datetime | None:
    """First commit adding files under the project dir
    (user_corpus.py:178-183)."""
    rel = os.path.join("projects", project)
    out = run_git(["log", "--reverse", "--diff-filter=A",
                   "--pretty=format:%cI", "--", rel], repo_path)
    if not out:
        return None
    return _parse_iso(out.splitlines()[0].strip())


def corpus_commit(repo_path: str, project: str,
                  needle: str = SEED_CORPUS_NEEDLE
                  ) -> tuple[str | None, datetime | None]:
    """(sha, time) of the first build.sh commit mentioning the seed-corpus
    archive (user_corpus.py:86-98,189-190)."""
    rel = os.path.join("projects", project, "build.sh")
    out = run_git(["log", "--reverse", f"-S{needle}",
                   "--pretty=format:%H%n%cI", "--", rel], repo_path)
    if not out:
        return None, None
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if len(lines) < 2:
        return None, None
    return lines[0], _parse_iso(lines[1])


@dataclass
class GitHubMergeTimeResolver:
    """Commit sha -> containing PR's merge time, via two API hops
    (user_corpus.py:113-142).  ``fetcher`` handles retries; a missing token
    downgrades to never resolving (the reference skips the call,
    user_corpus.py:108-111)."""

    fetcher: Fetcher | None
    token: str | None = None
    owner: str = "google"
    repo: str = "oss-fuzz"

    def merge_time(self, commit_sha: str) -> datetime | None:
        if self.fetcher is None or not self.token:
            return None
        base = GITHUB_API.format(owner=self.owner, repo=self.repo)
        resp = self.fetcher.get(f"{base}/commits/{commit_sha}/pulls",
                                params={"state": "closed", "per_page": 1})
        if resp is None:
            return None
        pulls = resp.json()
        if not pulls:
            return None
        pr_resp = self.fetcher.get(f"{base}/pulls/{pulls[0]['number']}")
        if pr_resp is None:
            return None
        return _parse_iso(pr_resp.json().get("merged_at"))


def analyze_repository(repo_path: str, project_names: list[str],
                       resolver: GitHubMergeTimeResolver | None = None
                       ) -> table.Table:
    """Per-project corpus timeline rows (user_corpus.py:157-217).
    Projects with no creation commit are skipped; projects without a
    build.sh get a row with null corpus fields."""
    resolver = resolver or GitHubMergeTimeResolver(fetcher=None)
    rows = []
    for name in project_names:
        created = project_creation_time(repo_path, name)
        if created is None:
            continue
        build_sh = os.path.join(repo_path, "projects", name, "build.sh")
        row = {"project_name": name, "is_Corpus": False,
               "corpus_commit_time": None, "corpus_merged_time": None,
               "project_creation_time": created,
               "time_elapsed_seconds": None,
               "merged_time_elapsed_seconds": None}
        if os.path.exists(build_sh):
            sha, commit_time = corpus_commit(repo_path, name)
            if commit_time is not None:
                row["is_Corpus"] = True
                row["corpus_commit_time"] = commit_time
                row["time_elapsed_seconds"] = (
                    commit_time - created).total_seconds()
                merged = resolver.merge_time(sha) if sha else None
                if merged is not None:
                    row["corpus_merged_time"] = merged
                    row["merged_time_elapsed_seconds"] = (
                        merged - created).total_seconds()
        rows.append(row)
    return table.from_records(rows, columns=CSV_HEADER)


def run_corpus_collector(repo_path: str, out_csv: str,
                         resolver: GitHubMergeTimeResolver | None = None,
                         force: bool = False) -> table.Table:
    """Analyze every project dir and write the CSV; an existing CSV short
    -circuits unless ``force`` (user_corpus.py:367-370)."""
    if os.path.exists(out_csv) and not force:
        log.info("%s exists; skipping git analysis", out_csv)
        return table.read_csv(out_csv)
    projects_dir = os.path.join(repo_path, "projects")
    names = sorted(d for d in os.listdir(projects_dir)
                   if os.path.isdir(os.path.join(projects_dir, d)))
    t = analyze_repository(repo_path, names, resolver)
    table.write_csv(t, out_csv)
    log.info("wrote %d corpus rows to %s", len(t), out_csv)
    return t


__all__ = ["CSV_HEADER", "GitHubMergeTimeResolver", "analyze_repository",
           "corpus_commit", "project_creation_time", "run_corpus_collector"]
