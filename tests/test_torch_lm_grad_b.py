"""`Model.loss` and its gradients against the JAX reference for the other
five LM configs (see ``test_torch_lm_grad_a.py``, whose helpers this file
uses)."""
import pytest

from test_torch_lm_grad_a import check_grads, check_loss, loss_and_grads

ARCHS = ["zamba2-2.7b", "qwen2-moe-a2.7b", "qwen1.5-32b", "qwen2-vl-72b", "whisper-base"]


@pytest.fixture(scope="module", params=ARCHS)
def twin(request):
    return loss_and_grads(request.param)


def test_loss_matches_reference(twin):
    check_loss(*twin)


def test_grads_match_reference(twin):
    check_grads(*twin)
