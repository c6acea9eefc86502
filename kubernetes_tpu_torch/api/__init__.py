from kubernetes_tpu_torch.api.types import *  # noqa: F401,F403
from kubernetes_tpu_torch.api import quantity  # noqa: F401
