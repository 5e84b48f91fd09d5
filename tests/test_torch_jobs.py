"""The port's ``utils/jobs.py`` (a copy of the JAX package's, which it may
not import) against the JAX package's on the same inputs: ``run_jobs``
over ``JOB=1:N`` commands and logs, the ``pick`` of failed or incomplete
jobs and the batch failure, and ``split_scp``."""

import re

import pytest

from robustsq_whisper_tpu.utils import jobs as jjobs
from robustsq_whisper_torch.utils import jobs as tjobs


def _logs(root, n):
    """Each job's log without its wall-clock lines."""
    return [
        re.sub(r" at .*$", "", (root / f"log.{j}").read_text(), flags=re.M).replace(str(root), "ROOT")
        for j in range(1, n + 1)
    ]


def _run(mod, root, **kw):
    cmd = f"echo job JOB; echo JOB > {root}/out.JOB; test JOB -ne 3"
    try:
        res = mod.run_jobs(cmd, str(root / "log.JOB"), jobs=(1, 4), max_jobs_run=2, **kw)
        return [(r.job_id, r.returncode) for r in res], None
    except RuntimeError as e:
        return None, str(e).replace(str(root), "ROOT")


def test_run_jobs_matches_jax(tmp_path):
    """Job 3 fails: both raise with the same message after running all
    four, and write the same logs and outputs; a rerun with ``pick=failed``
    runs job 3 alone, ``pick=incomplete`` none (every log has its end
    marker) once the log of job 2 is cut short, job 2 alone."""
    roots = {k: tmp_path / k for k in ("jax", "port")}
    for root in roots.values():
        root.mkdir()
    first = {k: _run(m, roots[k]) for k, m in (("jax", jjobs), ("port", tjobs))}
    assert first["port"] == first["jax"] and first["port"][1].startswith("1/4 jobs failed")
    assert _logs(roots["port"], 4) == _logs(roots["jax"], 4)
    assert "# Ended (code 1)" in _logs(roots["port"], 4)[2]
    for k in roots:
        assert (roots[k] / "out.4").read_text() == "4\n"
    for pick in ("failed", "incomplete"):
        got = {k: _run(m, roots[k], pick=pick) for k, m in (("jax", jjobs), ("port", tjobs))}
        assert got["port"] == got["jax"]
    assert _run(tjobs, roots["port"], pick="incomplete") == ([], None)
    for root in roots.values():  # job 2 was cut before its end marker
        log = root / "log.2"
        log.write_text(log.read_text().split("# Ended")[0])
    got = {k: _run(m, roots[k], pick="incomplete") for k, m in (("jax", jjobs), ("port", tjobs))}
    assert got["port"] == got["jax"] == ([(2, 0)], None)


@pytest.mark.parametrize("n_splits", [1, 3, 4])
@pytest.mark.parametrize("by_speaker", [False, True])
def test_split_scp_matches_jax(n_splits, by_speaker):
    scp = {f"spk{i % 3}_utt{i:02d}": f"/data/{i}.wav" for i in range(10)}
    utt2spk = {k: k.split("_")[0] for k in scp} if by_speaker else None
    got = tjobs.split_scp(scp, n_splits, utt2spk)
    assert got == jjobs.split_scp(scp, n_splits, utt2spk)
    assert sorted(k for c in got for k in c) == sorted(scp)
    if by_speaker:  # no speaker in two chunks
        owners = {}
        for i, chunk in enumerate(got):
            for k in chunk:
                assert owners.setdefault(utt2spk[k], i) == i
