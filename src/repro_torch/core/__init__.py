"""The paper's circuits and the numerics built from them, exported under
the reference's names.

Faithful layer:
  circuit.JugglePAC / circuit.INTAC      cycle-accurate simulators (plain
                                         Python)
  circuit_scan.jugglepac_scan            the same FSM as a batched scan
                                         (a hand-written kernel on the card)

Production layer: the numerics shared by the accuracy policies
(``intac``), the segment-id utilities (``segmented``), the fixed pairing
trees (``trees``) and the gradient juggler (``juggler``)."""

from . import (circuit, circuit_scan, intac, juggler,  # noqa: F401
               segmented, trees)
from .circuit import INTAC, JugglePAC, jugglepac_min_set_size  # noqa: F401
from .intac import (Limb3State, LimbState, bin_psum,  # noqa: F401
                    compressed_psum_mean, compressed_psum_mean_tree,
                    intac_psum, intac_psum2, intac_psum3, intac_sum,
                    limb3_finalize, limb3_merge_across, limb3_init, limb_add, limb_add3,
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
