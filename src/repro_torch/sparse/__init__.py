"""Sparse inference runtime: the 2:4 compressed format, the unstructured
``BitMask`` storage, the mask bank and compressed execution (port of
``repro.sparse``)."""
from repro_torch.sparse.formats import (BitMask, SparseTensor,  # noqa: F401
                                        sparse_leaves)
from repro_torch.sparse.pack import (pack_mask_tree, pack_nm,  # noqa: F401
                                     unpack_mask_tree)
