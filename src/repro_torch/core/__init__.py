"""Numerics shared by the accuracy policies (``intac``), the segment-id
utilities (``segmented``), the fixed pairing trees (``trees``) and the
gradient juggler (``juggler``), exported under the reference's names."""

from . import intac, juggler, segmented, trees  # noqa: F401
from .intac import (Limb3State, LimbState, intac_sum,  # noqa: F401
                    limb3_finalize, limb3_init, limb_add, limb_add3,
                    limb_finalize, limb_init, limb_merge, limb_merge3,
                    limb_split3, limbs_canonical, limbs_resolve,
                    limbs_resolve3)
from .juggler import (juggler_finalize, juggler_init,  # noqa: F401
                      juggler_push, num_slots_for)
from .segmented import (combine_flash_partials_tree,  # noqa: F401
                        flash_partial_combine, segment_mean, segment_sum_ref,
                        segments_from_lengths)
from .trees import (pairwise_tree_sum, pairwise_tree_sum_pytree,  # noqa: F401
                    tree_combine)
