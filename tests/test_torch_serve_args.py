"""``serve``'s command line on the port against the reference's, on the
CPU: the same argv must serve the same mode on both packages."""
import argparse

import pytest

from repro.launch import serve as jserve

from repro_torch.launch import serve as tserve

ARCH = "granite-moe-1b-a400m"


class _Parsed(Exception):
    """Raised by the stub once the reference's argv is parsed."""


def _reference_args(argv, monkeypatch):
    """The namespace the reference's ``serve.main`` parses from ``argv``;
    it serves nothing (``parse_args`` is stubbed to stop there)."""
    parse = argparse.ArgumentParser.parse_args
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["args"] = parse(self, args, namespace)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        jserve.main(argv)
    monkeypatch.undo()
    return seen["args"]


@pytest.mark.parametrize("argv", [
    [],
    ["--arch", ARCH, "--reduced", "--batch", "2"],
    ["--matrix", "mawi_like", "--scale", "0.01", "--requests", "8"],
])
def test_same_argv_serves_the_same_mode(argv, monkeypatch):
    port = tserve.build_parser().parse_args(argv)
    ref = _reference_args(argv, monkeypatch)
    assert port.mode == ref.mode == "lm"
    for name in ("arch", "reduced", "batch", "prompt_len", "gen", "seed",
                 "matrix", "scale", "requests", "max_batch"):
        assert getattr(port, name) == getattr(ref, name), name


def test_serve_without_mode_serves_the_lm():
    res = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--impl", "plain", "--batch", "2", "--prompt-len",
                       "8", "--gen", "2"])
    gen = res["tokens"]
    assert gen.shape == (2, 2)
    assert ((gen >= 0) & (gen < res["cfg"].vocab)).all()
    assert res["cfg"].moe_use_kernel and res["cfg"].moe_plain
