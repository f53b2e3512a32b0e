"""tools/kernel_variants.py's patches against the sources they patch.

Each variant there is a copy of gesturediffusion_tpu_torch/csrc/ with a few
lines replaced; a patch whose text no longer matches the sources used to
show only on the card, when the copy was built.  Here every patch of every
variant is applied on the CPU, in order, as the tool applies them (a whole
file from tools/variants/ where the patch names one), and each must find
the text it replaces; a variant's libraries must be ones the tool builds.
"""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "kernel_variants", os.path.join(ROOT, "tools", "kernel_variants.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TOOL = _tool()


@pytest.mark.parametrize("name", sorted(TOOL.VARIANTS))
def test_every_patch_finds_the_text_it_replaces(name):
    patches = TOOL.VARIANTS[name]
    files = TOOL.patched_sources(name, patches)
    assert files and set(files) == {fname for fname, _, _ in patches}
    for fname, old, new in patches:
        assert os.path.isfile(os.path.join(TOOL.CSRC, fname)), fname
        if old is not None:
            assert old != new, (name, old)
    assert set(TOOL.VARIANT_LIBS[name]) <= set(TOOL.LIBS)
