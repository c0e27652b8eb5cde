"""The files the port reads are its own: the committed flow-net weights
(``ldiffusion_tpu_torch/artifacts/flownet_{synthetic,transformed}.npz``) are
byte-equal copies (sha256) of the JAX package's ``ldiffusion_tpu/artifacts/``
files, ``FlowNetProposer.load_pretrained`` reads the port's copies, and no
module of the port names a path under ``ldiffusion_tpu/``."""
import hashlib
import re
from pathlib import Path

import pytest

from ldiffusion_tpu_torch.cell import instance

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ldiffusion_tpu_torch"
DOMAINS = ("synthetic", "transformed")


def _sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_artifacts_lie_in_the_port():
    assert instance.ARTIFACTS.resolve().is_relative_to(PORT.resolve())


@pytest.mark.parametrize("domain", DOMAINS)
def test_flownet_weights_are_byte_equal_to_the_jax_packages(domain):
    ours = instance.ARTIFACTS / f"flownet_{domain}.npz"
    theirs = REPO / "ldiffusion_tpu" / "artifacts" / f"flownet_{domain}.npz"
    assert _sha256(ours) == _sha256(theirs)


@pytest.mark.parametrize("domain", DOMAINS)
def test_load_pretrained_reads_the_ports_copy(domain, monkeypatch):
    read = []
    monkeypatch.setattr(instance.FlowNetProposer, "load",
                        classmethod(lambda cls, path, device=None, **kw: read.append(path)))
    instance.FlowNetProposer.load_pretrained(domain, device="cpu")
    assert [Path(p).resolve() for p in read] == \
        [(PORT / "artifacts" / f"flownet_{domain}.npz").resolve()]


def test_a_missing_artifact_names_the_ports_directory(monkeypatch, tmp_path):
    monkeypatch.setattr(instance, "ARTIFACTS", tmp_path)
    with pytest.raises(FileNotFoundError, match="ldiffusion_tpu_torch/artifacts"):
        instance.FlowNetProposer.load_pretrained("synthetic", device="cpu")


def test_no_module_of_the_port_names_a_path_of_the_jax_package():
    path_of_jax = re.compile(r"""/\s*["']ldiffusion_tpu["']|["'](\.\./)?ldiffusion_tpu/""")
    found = [f"{p.relative_to(REPO)}:{i}" for p in sorted(PORT.rglob("*.py"))
             for i, line in enumerate(p.read_text().splitlines(), 1) if path_of_jax.search(line)]
    assert found == []
