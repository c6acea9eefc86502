"""kubernetes_tpu_torch.models — hollow cluster generators
(`hollow.py`, the kubemark analog), copied from the reference
(`kubernetes_tpu.models`)."""
