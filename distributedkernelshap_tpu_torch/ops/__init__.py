from distributedkernelshap_tpu_torch.ops.coalitions import CoalitionPlan, coalition_plan  # noqa: F401
from distributedkernelshap_tpu_torch.ops.cuda_kernels import (  # noqa: F401
    exact_tree_phi,
    exact_tree_phi_plain,
    fused_linear_ey,
    fused_linear_ey_plain,
)
from distributedkernelshap_tpu_torch.ops.explain import (  # noqa: F401
    ShapConfig,
    build_explainer_fn,
    groups_to_matrix,
)
from distributedkernelshap_tpu_torch.ops.links import convert_to_link, identity_link, logit_link  # noqa: F401
