"""The GCN phage-contig scorer and the scoring stage."""
from palace_tpu_torch.models.gcn import (
    GCNConfig,
    forward,
    init_params,
    load_torch_state_dict,
    model_inputs_from_features,
    params_from_numpy_state,
    phage_probabilities,
)
