"""The faults of the ``bma_requests`` kind: the BMA pass's, in the members'
logits that every request's ``logits_all`` computes."""

from portbench.tests.tiny.faults.bma_pass import FAULTS  # noqa: F401
