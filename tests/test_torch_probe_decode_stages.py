"""``python -m mxnet_tpu_torch.tools.probe_decode_stages`` builds each of
its variants by one exact text substitution in
``csrc/flash_decode_fwd.cu``; the probe runs only on a card, so this
holds its cut points to the source here: each must occur exactly once,
or the probe refuses to build the variant."""
import os

import pytest

from mxnet_tpu_torch.ops.kernels import _build
from mxnet_tpu_torch.tools import probe_decode_stages as probe


@pytest.mark.parametrize('name', sorted(probe.VARIANTS))
def test_variant_cuts_occur_once_in_the_decode_source(name):
    with open(os.path.join(_build._CSRC, 'flash_decode_fwd.cu')) as f:
        text = f.read()
    for old, _ in probe.VARIANTS[name]:
        assert text.count(old) == 1, (name, old)
