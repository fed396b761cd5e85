"""Job orchestration for the port: manifest rendering, validation, the
local gang executor, the elastic reconcile loop and the on-cluster watch
(the port's own copy of ``k8s_distributed_deeplearning_tpu/launch/``)."""

from k8s_distributed_deeplearning_torch.launch.render import (  # noqa: F401
    render_tpujob,
    render_all,
    to_yaml,
)
# NOTE: the `validate` FUNCTION is deliberately not re-exported at package
# level — it would shadow the `launch.validate` MODULE in this namespace
# (breaking `from ...launch import validate` module imports). Use
# `launch.validate.validate(docs)` or `validate_or_raise` below.
from k8s_distributed_deeplearning_torch.launch.validate import (  # noqa: F401
    kubectl_validate,
    validate_or_raise,
)
from k8s_distributed_deeplearning_torch.launch import validate  # noqa: F401,E402
from k8s_distributed_deeplearning_torch.launch.local_executor import (  # noqa: F401
    WorkerResult,
    run_local,
)
from k8s_distributed_deeplearning_torch.launch.elastic import (  # noqa: F401
    resize_to,
    run_elastic,
)
