"""kubernetes_tpu_torch.cmd — the scheduler command (`scheduler.py`, the
kube-scheduler binary), copied from the reference (`kubernetes_tpu.cmd`)."""
