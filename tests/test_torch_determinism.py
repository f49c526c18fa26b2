"""``utils/determinism.py``'s ``Deterministic`` on the CPU: ``reasons`` names
only the ops that torch says have no deterministic form, and every other
warning raised in the block still reaches the caller's warning filters."""

import warnings

import pytest
import torch

from tpu_unet_torch.utils.determinism import Deterministic


def _unpool():
    # An op that torch's deterministic mode flags on the CPU, too.
    torch.nn.functional.max_unpool1d(torch.rand(1, 1, 2), torch.tensor([[[0, 1]]]), 2)


def test_reasons_hold_only_nondeterministic_ops():
    with warnings.catch_warnings(record=True) as outer:
        warnings.simplefilter("always")
        with Deterministic() as det:
            _unpool()
            warnings.warn("unclosed file <car_0001.png>", ResourceWarning)
    assert len(det.reasons) == 1 and "does not have a deterministic implementation" in \
        det.reasons[0] and "max_unpool" in det.reasons[0]
    # The ResourceWarning is warned again on exit; the op's is not.
    assert [(w.category, str(w.message)) for w in outer] == \
        [(ResourceWarning, "unclosed file <car_0001.png>")]
    assert outer[0].filename == __file__


def test_other_warnings_follow_the_callers_filters():
    with warnings.catch_warnings():
        warnings.simplefilter("error", ResourceWarning)
        with pytest.raises(ResourceWarning, match="unclosed"):
            with Deterministic():
                warnings.warn("unclosed file", ResourceWarning)
    with warnings.catch_warnings(record=True) as outer:
        warnings.simplefilter("ignore", ResourceWarning)
        warnings.simplefilter("always", UserWarning)
        with Deterministic() as det:
            warnings.warn("unclosed file", ResourceWarning)
            warnings.warn("a user warning")
    assert det.reasons == [] and [str(w.message) for w in outer] == ["a user warning"]
    assert not torch.are_deterministic_algorithms_enabled()
