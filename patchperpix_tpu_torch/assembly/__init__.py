from .vote_instances import (VoteInstancesParams, numinst_from_probs,  # noqa: F401
                             to_instance_seg)
