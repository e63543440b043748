from repro_torch.data.partition import (dirichlet_label_partition,
                                        natural_sizes, partition_sizes,
                                        quantity_skew_sizes)
from repro_torch.data.synthetic import (make_classification_clients,
                                        make_classification_population)

__all__ = [
    "dirichlet_label_partition", "natural_sizes", "partition_sizes",
    "quantity_skew_sizes", "make_classification_clients",
    "make_classification_population",
]
