"""kubernetes_tpu_torch.apis — the component configuration
(`config.SchedulerConfiguration`) and the scheduler Policy schema
(`policy.Policy`), copied from the reference (`kubernetes_tpu.apis`)."""
