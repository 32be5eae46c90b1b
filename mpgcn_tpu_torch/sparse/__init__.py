"""The sparse support plane: padded-CSR and blocked-ELL support
containers, the SpMMs over them (the ELL kernels on the card) and the
density analyzer. ``parallel/halo.py`` adds the node-sharded SpMM with one
halo exchange a layer."""

from mpgcn_tpu_torch.sparse.formats import (  # noqa: F401
    SPARSE_DENSITY_DEFAULT,
    BlockedELL,
    PaddedCSR,
    analyze_support,
    csr_from_dense,
    ell_from_dense,
    plan_pad_width,
    recommend_format,
    sparsify_support_stack,
)
from mpgcn_tpu_torch.sparse.kernels import (  # noqa: F401
    bdgcn_sparse,
    csr_spmm,
    ell_spmm,
)
