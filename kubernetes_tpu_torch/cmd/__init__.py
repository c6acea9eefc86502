"""kubernetes_tpu_torch.cmd — the scheduler command (`scheduler.py`, the
kube-scheduler binary), the cluster-in-a-process (`cluster.py`, the
kubeadm analog) and the CLI (`kubectl.py`), copied from the reference
(`kubernetes_tpu.cmd`)."""
