"""The port's tuned launch profile (``repro_torch.launch.profile``) as pure
functions, beside the reference's ``repro.launch.profile``: the allocator
options merged by key with the user's winning, tcmalloc preloaded only where
one of the reference's two paths exists (``os.path.exists`` monkeypatched),
the re-exec once under the sentinel (``os.execve`` monkeypatched), and the
launcher calling it before it touches a device."""
import os
import sys

import pytest

from repro.launch import profile as jprofile
from repro_torch.launch import profile, serve

LIB, LIB_MIN = profile.TCMALLOC_CANDIDATES


def _exists(*present):
    return lambda path: path in present


def test_candidates_and_sentinel_are_the_references():
    assert profile.TCMALLOC_CANDIDATES == jprofile.TCMALLOC_CANDIDATES
    assert profile._SENTINEL == jprofile._SENTINEL == "REPRO_TUNED_REEXEC"


@pytest.mark.parametrize("existing,want", [
    ("", "expandable_segments:True"),
    ("max_split_size_mb:128", "max_split_size_mb:128,expandable_segments:True"),
    ("expandable_segments:False", "expandable_segments:False"),
    (" garbage_collection_threshold:0.6 , expandable_segments:False ,",
     "garbage_collection_threshold:0.6,expandable_segments:False"),
])
def test_merge_alloc_conf_dedups_by_key_and_the_user_wins(existing, want):
    assert profile.merge_alloc_conf(existing, profile.TUNED_ALLOC_CONF) == want


def test_merge_alloc_conf_follows_merge_xla_flags():
    """The same rule as the reference's flag merge: first seen wins, order kept."""
    ours = profile.merge_alloc_conf("a:1,b:2", ["b:3", "c:4", "a:5"])
    ref = jprofile.merge_xla_flags("a=1 b=2", ["b=3", "c=4", "a=5"])
    assert ours.replace(":", "=").split(",") == ref.split()


def test_default_profile_returns_the_environment_untouched():
    env = {"PATH": "/bin", "PYTORCH_CUDA_ALLOC_CONF": "x:1"}
    out = profile.apply_profile("default", env)
    assert out == env and out is not env


def test_unknown_profile_raises():
    with pytest.raises(ValueError, match="unknown launch profile"):
        profile.apply_profile("fast", {})


@pytest.mark.parametrize("present,lib", [((LIB,), LIB), ((LIB_MIN,), LIB_MIN),
                                         ((LIB, LIB_MIN), LIB), ((), None)])
def test_tuned_preloads_tcmalloc_only_where_it_exists(present, lib, monkeypatch):
    monkeypatch.setattr(os.path, "exists", _exists(*present))
    env = profile.apply_profile("tuned", {"PATH": "/bin"})
    assert env["PYTORCH_CUDA_ALLOC_CONF"] == "expandable_segments:True"
    if lib is None:
        assert "LD_PRELOAD" not in env and "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD" not in env
    else:
        assert env["LD_PRELOAD"] == lib
        assert env["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == "60000000000"
    # the reference's profile picks the same library under the same paths
    ref = jprofile.apply_profile("tuned", {"PATH": "/bin"})
    assert ref.get("LD_PRELOAD") == env.get("LD_PRELOAD")
    assert ref.get("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD") == \
        env.get("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD")


def test_tuned_appends_to_a_preload_once_and_keeps_a_set_threshold(monkeypatch):
    monkeypatch.setattr(os.path, "exists", _exists(LIB))
    env = profile.apply_profile("tuned", {"LD_PRELOAD": "/x.so",
                                          "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "1"})
    assert env["LD_PRELOAD"] == f"/x.so:{LIB}"
    assert env["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == "1"
    again = profile.apply_profile("tuned", env)
    assert again["LD_PRELOAD"] == env["LD_PRELOAD"]


def test_apply_profile_leaves_os_environ_alone(monkeypatch):
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    env = profile.apply_profile("tuned")
    assert "PYTORCH_CUDA_ALLOC_CONF" in env and "PYTORCH_CUDA_ALLOC_CONF" not in os.environ


class _Exec:
    def __init__(self):
        self.calls = []

    def __call__(self, path, args, env):
        self.calls.append((path, args, env))


def test_maybe_reexec_runs_the_launcher_once_under_the_sentinel(monkeypatch):
    monkeypatch.delenv(profile._SENTINEL, raising=False)
    monkeypatch.setattr(os.path, "exists", _exists())
    spy, lines = _Exec(), []
    monkeypatch.setattr(os, "execve", spy)
    profile.maybe_reexec("tuned", ["serve.py", "--arch", "yi-6b"], log=lines.append)
    (path, args, env), = spy.calls
    assert path == sys.executable
    assert args == [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "yi-6b"]
    assert env[profile._SENTINEL] == "1"
    assert env["PYTORCH_CUDA_ALLOC_CONF"] == "expandable_segments:True"
    assert len(lines) == 1 and "re-exec under 'tuned' profile" in lines[0]
    assert "tcmalloc not found, skipped" in lines[0]
    # the re-launched child runs straight through
    monkeypatch.setenv(profile._SENTINEL, "1")
    profile.maybe_reexec("tuned", ["serve.py"], log=lines.append)
    assert len(spy.calls) == 1 and len(lines) == 1


def test_maybe_reexec_names_the_preloaded_library(monkeypatch):
    monkeypatch.delenv(profile._SENTINEL, raising=False)
    monkeypatch.delenv("LD_PRELOAD", raising=False)
    monkeypatch.setattr(os.path, "exists", _exists(LIB_MIN))
    spy, lines = _Exec(), []
    monkeypatch.setattr(os, "execve", spy)
    profile.maybe_reexec("tuned", ["serve.py"], log=lines.append)
    assert f"LD_PRELOAD={LIB_MIN}" in lines[0] and spy.calls[0][2]["LD_PRELOAD"] == LIB_MIN


def test_maybe_reexec_default_is_a_no_op(monkeypatch):
    spy = _Exec()
    monkeypatch.setattr(os, "execve", spy)
    monkeypatch.delenv(profile._SENTINEL, raising=False)
    profile.maybe_reexec("default", ["serve.py"], log=lambda s: None)
    assert spy.calls == []


def test_the_launcher_reexecs_before_it_touches_a_device(monkeypatch):
    """``serve.main(... --profile tuned)`` re-executes with its own command
    line before it resolves the device: here the re-exec is stubbed to
    raise, and the run never reaches the (absent) card."""
    monkeypatch.delenv(profile._SENTINEL, raising=False)

    class Reexec(Exception):
        pass

    def stop(path, args, env):
        raise Reexec(args)

    monkeypatch.setattr(os, "execve", stop)
    argv = ["--arch", "yi-6b", "--device", "cuda", "--bns-iters", "0", "--profile", "tuned"]
    with pytest.raises(Reexec) as exc:
        serve.main(argv)
    assert exc.value.args[0][-len(argv):] == argv
    assert exc.value.args[0][1:3] == ["-m", "repro_torch.launch.serve"]
