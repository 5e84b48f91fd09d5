"""Local parallel job runner: Kaldi's ``utils/run.pl``, the JAX package's
``utils/jobs.py`` (pure Python, copied).

The contract of Kaldi's launcher: ``JOB=1:N`` array expansion in the
command and log path, per-job log files with start/end markers and exit
status, ``--max-jobs-run`` throttling, a ``pick`` filter to rerun only
``failed`` or ``incomplete`` jobs, and fail-the-batch-if-any-job-fails
semantics, for the local case (``run_jobs``).

Also ``split_scp``: scp splitting for array jobs that keeps each speaker
in one chunk (``utils/split_scp.pl --utt2spk-file``).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class JobResult:
    job_id: int
    returncode: int
    log_path: str
    seconds: float


def _expand(template: str, job: int) -> str:
    return template.replace("JOB", str(job))


def _log_status(log_path: str) -> Optional[int]:
    """Parse a previous run's log: None if incomplete, else exit code."""
    if not os.path.exists(log_path):
        return None
    try:
        with open(log_path) as f:
            tail = f.read()[-4096:]
    except OSError:
        return None
    for line in reversed(tail.splitlines()):
        if line.startswith("# Ended (code "):
            try:
                return int(line.split("code", 1)[1].split(")")[0].strip())
            except ValueError:
                return None
    return None


def run_jobs(
    command: str,
    log: str,
    jobs: Tuple[int, int] = (1, 1),
    max_jobs_run: Optional[int] = None,
    pick: Optional[str] = None,  # None | "failed" | "incomplete"
    shell: str = "bash",
) -> List[JobResult]:
    """Run ``command`` for JOB in [jobs[0], jobs[1]], JOB substituted into the
    command and log path. Raises RuntimeError if any job fails."""
    lo, hi = jobs
    ids = list(range(lo, hi + 1))
    if pick == "failed":
        ids = [j for j in ids if (_log_status(_expand(log, j)) or 0) != 0]
    elif pick == "incomplete":
        ids = [j for j in ids if _log_status(_expand(log, j)) is None]

    def one(job: int) -> JobResult:
        log_path = _expand(log, job)
        os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
        cmd = _expand(command, job)
        t0 = time.time()
        with open(log_path, "w") as f:
            f.write(f"# Running: {cmd}\n# Started at {time.ctime()}\n")
            f.flush()
            proc = subprocess.run(
                [shell, "-c", cmd], stdout=f, stderr=subprocess.STDOUT
            )
            f.write(f"# Ended (code {proc.returncode}) at {time.ctime()}\n")
        return JobResult(job, proc.returncode, log_path, time.time() - t0)

    workers = max_jobs_run or len(ids) or 1
    with ThreadPoolExecutor(max_workers=workers) as pool:
        results = list(pool.map(one, ids))

    failed = [r for r in results if r.returncode != 0]
    if failed:
        raise RuntimeError(
            f"{len(failed)}/{len(results)} jobs failed; first log: "
            f"{failed[0].log_path}"
        )
    return results


def split_scp(
    scp: Dict[str, str],
    n_splits: int,
    utt2spk: Optional[Dict[str, str]] = None,
) -> List[Dict[str, str]]:
    """Split an scp map into n chunks; with utt2spk, never split a speaker
    across chunks (utils/split_scp.pl --utt2spk-file semantics)."""
    keys = sorted(scp)
    if not utt2spk:
        out = []
        per = -(-len(keys) // n_splits)
        for i in range(n_splits):
            chunk = keys[i * per : (i + 1) * per]
            out.append({k: scp[k] for k in chunk})
        return out
    # group by speaker, round-robin greedy by size
    groups: Dict[str, List[str]] = {}
    for k in keys:
        groups.setdefault(utt2spk.get(k, k), []).append(k)
    chunks: List[Dict[str, str]] = [dict() for _ in range(n_splits)]
    sizes = [0] * n_splits
    for spk in sorted(groups):
        tgt = sizes.index(min(sizes))
        for k in groups[spk]:
            chunks[tgt][k] = scp[k]
        sizes[tgt] += len(groups[spk])
    return chunks
