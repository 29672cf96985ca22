"""panvc3_tpu_torch — the PyTorch/CUDA port of panvc3_tpu for an NVIDIA H100.

The package sits beside ``panvc3_tpu``, which stays the reference it is
tested against.  It imports ``torch``, and nothing of ``jax`` or of
``panvc3_tpu``: the host modules it needs are copies of the originals,
trimmed to what the port calls and kept at the same module paths and
names (``alphabet``, ``cigar``, ``bitvec``, ``msa_index``, ``seqbuf``,
``utils``, ``io.bgzf``, ``io.fasta``, ``io.sam``, ``io.bed``, ``io.vcf``,
``align``, ``indel_runs``, ``rewrite``, ``projector``,
``ops.event_geometry``, and the eight host tools under ``pipeline``).  The
C sources under ``native/`` stay shared: they hold no JAX, import nothing
of ``panvc3_tpu``, and the port compiles them into its own build
directory.  Everything that ran on the TPU is ported here, mirroring the
old layout and names:

- ``panvc3_tpu_torch.native``        builds and loads the C host extension
- ``panvc3_tpu_torch.ops``           the realignment DP (hand-written CUDA
  kernels and their plain PyTorch versions) and the wire functions around
  it; in plain PyTorch the device gap index, the rewrite math and gap
  kernel, the event geometry (host and device) and the batch projector
- ``panvc3_tpu_torch.pipeline``      project_alignments: the fast lane and
  the object path (device engine) and the host engine; the other eight
  tools, which run on the host as they do in ``panvc3_tpu``
- ``panvc3_tpu_torch.io``            SAM/BAM, BGZF, FASTA, BED, VCF
- ``panvc3_tpu_torch.cli``           ``python -m panvc3_tpu_torch <tool>``, all nine;
  installed, the commands ``panvc3_torch_<tool>``
- ``panvc3_tpu_torch/workflows/``    the Snakemake workflows that run them

Device choice is explicit: functions take a ``torch.device``; the CLI's
``--device`` defaults to ``cuda`` and raises when no card is present.
``cpu`` runs the plain PyTorch versions and exists for the tests.
"""

import os
import pathlib

__version__ = "0.1.0"

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent


def checkout_root() -> pathlib.Path | None:
    """Root of the source checkout that holds the package, or None when the
    package is installed: a checkout has ``pyproject.toml`` and the shared
    C sources (``native/``) beside the package."""
    root = PACKAGE_DIR.parent
    if (root / "pyproject.toml").is_file() and (root / "native" / "panvc3_native.c").is_file():
        return root
    return None


def build_root() -> pathlib.Path:
    """Directory that holds what the package builds at first use (the C
    host extension and the CUDA kernels): ``build/panvc3_tpu_torch`` at the
    root of a checkout; in an install, which may be read-only,
    ``${XDG_CACHE_HOME:-~/.cache}/panvc3_tpu_torch``."""
    root = checkout_root()
    if root is not None:
        return root / "build" / "panvc3_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or str(pathlib.Path.home() / ".cache")
    return pathlib.Path(cache) / "panvc3_tpu_torch"


def resolve_device(device):
    """The torch.device named by ``device`` ('cuda', 'cuda:N' or 'cpu'),
    or for a list or tuple of such names (a mesh's devices, repeats
    allowed) the list of their torch.devices.  A CUDA entry raises when no
    card is present: nothing falls back to the CPU."""
    import torch

    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("an empty device list")
        return [resolve_device(d) for d in device]
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass --device cpu only to run the plain PyTorch "
                "versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
