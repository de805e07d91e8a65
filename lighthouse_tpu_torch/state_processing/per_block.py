"""The two altair reward helpers of block processing that the epoch
transition needs (spec `get_base_reward_per_increment`,
`get_base_reward_altair`).

The rest of block processing (operations, attestations, sync aggregates,
the signature sets) comes with the node wiring.
"""

from lighthouse_tpu_torch.state_processing.helpers import (
    get_total_active_balance,
    integer_squareroot,
)


def get_base_reward_per_increment(state, spec) -> int:
    return (
        spec.EFFECTIVE_BALANCE_INCREMENT
        * spec.BASE_REWARD_FACTOR
        // integer_squareroot(get_total_active_balance(state, spec))
    )


def get_base_reward_altair(state, index, spec) -> int:
    increments = (
        state.validators[index].effective_balance
        // spec.EFFECTIVE_BALANCE_INCREMENT
    )
    return increments * get_base_reward_per_increment(state, spec)
