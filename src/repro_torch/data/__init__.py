from repro_torch.data.partition import (dirichlet_label_partition,
                                        natural_sizes, partition_sizes,
                                        quantity_skew_sizes)
from repro_torch.data.synthetic import (make_classification_clients,
                                        make_classification_population,
                                        make_lm_clients)
from repro_torch.data.traces import (BehaviorRow, CapacityRow,
                                     load_behavior_trace, load_capacity_trace,
                                     save_behavior_trace, save_capacity_trace,
                                     synthesize_behavior_trace,
                                     synthesize_capacity_trace)

__all__ = [
    "dirichlet_label_partition", "natural_sizes", "partition_sizes",
    "quantity_skew_sizes", "make_classification_clients",
    "make_classification_population", "make_lm_clients",
    "BehaviorRow", "CapacityRow", "load_behavior_trace",
    "load_capacity_trace", "save_behavior_trace", "save_capacity_trace",
    "synthesize_behavior_trace", "synthesize_capacity_trace",
]
