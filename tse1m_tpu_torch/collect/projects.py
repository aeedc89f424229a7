"""C3, the project-info collector (reference: ``1_get_projects_infos.py``):
a port of ``tse1m_tpu/collect/projects.py``.

Walks an oss-fuzz checkout's ``projects/`` tree, flattens each project's
``project.yaml`` into scalar columns, stamps the first commit that touched
the project's directory, and writes ``project_info.csv`` as the reference
lays it out (``project, first_commit_datetime`` first, the other yaml
keys sorted: ``1_…py:130-133``).  ``project.yaml`` is read by
``collect/yaml_subset.py`` in place of PyYAML: a malformed file is
skipped with a warning, as the JAX package skips on ``yaml.YAMLError``,
and a construct outside the reader's subset stops the run, naming the
file and line.  Git is plain ``subprocess git``.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
from datetime import datetime

from . import table
from .yaml_subset import MalformedYaml, load_file

log = logging.getLogger("tse1m_tpu_torch.collect.projects")

OSS_FUZZ_URL = "https://github.com/google/oss-fuzz.git"


def run_git(args: list[str], repo_path: str) -> str | None:
    """Run git in ``repo_path``; None on failure (missing path or
    history)."""
    try:
        out = subprocess.run(["git", *args], cwd=repo_path, check=True,
                             capture_output=True, text=True, encoding="utf-8")
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        log.debug("git %s failed in %s: %s", " ".join(args), repo_path, e)
        return None
    return out.stdout.strip()


def clone_repo(url: str, clone_path: str) -> None:
    """Clone once; an existing checkout is reused (1_…py:35-44)."""
    if os.path.exists(clone_path):
        log.info("repository already present at %s; skipping clone",
                 clone_path)
        return
    os.makedirs(os.path.dirname(clone_path) or ".", exist_ok=True)
    log.info("cloning %s -> %s", url, clone_path)
    subprocess.run(["git", "clone", url, clone_path], check=True)


def first_commit_time(repo_path: str, rel_path: str) -> datetime | None:
    """Committer time of the first commit touching ``rel_path``
    (1_…py:12-19: ``iter_commits(paths=…, reverse=True)[0]``)."""
    out = run_git(["log", "--reverse", "--format=%cI", "--", rel_path],
                  repo_path)
    if not out:
        return None
    first = out.splitlines()[0].strip()
    try:
        return datetime.fromisoformat(first)
    except ValueError:
        return None


def flatten_yaml_value(value):
    """project.yaml values as CSV scalars (1_…py:25-33): dicts as JSON,
    empty sequences as None, lists through ``str()``."""
    if isinstance(value, dict):
        return json.dumps(value)
    if isinstance(value, (list, tuple)) and not value:
        return None
    if isinstance(value, list):
        return str(value)
    return value


def read_project_yaml(path: str) -> dict | None:
    try:
        data = load_file(path)
    except MalformedYaml as e:
        log.warning("unparseable project.yaml at %s: %s", path, e)
        return None
    return data if isinstance(data, dict) else None


def collect_project_info(repo_path: str) -> table.Table:
    """One row per project directory holding a project.yaml."""
    projects_dir = os.path.join(repo_path, "projects")
    if not os.path.isdir(projects_dir):
        raise FileNotFoundError(f"no projects/ directory under {repo_path}")
    names = sorted(d for d in os.listdir(projects_dir)
                   if os.path.isdir(os.path.join(projects_dir, d)))
    log.info("found %d project directories", len(names))

    records = []
    for name in names:
        yaml_path = os.path.join(projects_dir, name, "project.yaml")
        if not os.path.exists(yaml_path):
            log.warning("no project.yaml for %s; skipping", name)
            continue
        row: dict = {"project": name}
        row["first_commit_datetime"] = first_commit_time(
            repo_path, os.path.join("projects", name))
        data = read_project_yaml(yaml_path)
        if data:
            for key, value in data.items():
                row[key] = flatten_yaml_value(value)
        records.append(row)

    t = table.from_records(records)
    if "first_commit_datetime" in t:
        lead = ["project", "first_commit_datetime"]
        t = t.select(lead + sorted(c for c in t.columns if c not in lead))
    return t


def run_project_info_collector(repo_path: str, out_csv: str,
                               clone_url: str | None = None) -> table.Table:
    if clone_url:
        clone_repo(clone_url, repo_path)
    t = collect_project_info(repo_path)
    table.write_csv(t, out_csv)
    log.info("wrote %d project rows to %s", len(t), out_csv)
    return t


__all__ = ["OSS_FUZZ_URL", "clone_repo", "collect_project_info",
           "first_commit_time", "flatten_yaml_value", "read_project_yaml",
           "run_git", "run_project_info_collector"]
