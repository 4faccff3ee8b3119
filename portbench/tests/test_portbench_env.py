"""Where a run writes: every compile cache at a fixed directory inside the
checkout, git-ignored, and nothing under a fixed /tmp path or /dev/shm."""

import os
import re

from portbench.harness import env


def test_cache_variables_point_inside_the_checkout():
    environ = {}
    fixed = env.fix_caches(environ)
    assert set(fixed) == {"MULTIMODAL_EEG_FMRI_TPU_TORCH_CACHE_DIR",
                          "TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"}
    for var, path in fixed.items():
        assert os.path.commonpath([path, str(env.ROOT)]) == str(env.ROOT)
        assert path.startswith(str(env.BENCH / ".cache"))
        # fixed: no process id, time or temporary name in it
        assert str(os.getpid()) not in path and "tmp" not in path
    assert env.fix_caches({}) == fixed
    assert environ["USE_FLAX"] == "0"


def test_caches_and_output_are_git_ignored():
    ignored = (env.BENCH / ".gitignore").read_text().split()
    assert ".cache/" in ignored and "out/" in ignored


def test_no_source_names_a_fixed_temporary_path():
    for path in env.BENCH.rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"['\"]/(tmp|dev/shm)\b", text), path
