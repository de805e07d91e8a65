"""Chain specification: runtime constants + size presets.

Merges the reference's two-tier constant system — compile-time `EthSpec`
presets (consensus/types/src/eth_spec.rs:51,238,281) and runtime `ChainSpec`
values (consensus/types/src/chain_spec.rs:32,431,596) — into one `Spec`
object. In Rust the split exists to monomorphize SSZ array sizes; in Python
container classes are built per-spec by `lighthouse_tpu_torch.types.containers`,
so a single object carries both tiers (fields are grouped and documented to
preserve the mapping).

Values are the published Ethereum consensus-spec mainnet/minimal constants
(phase0 + altair).
"""

from dataclasses import dataclass, field, fields, replace

FAR_FUTURE_EPOCH = 2**64 - 1
GENESIS_EPOCH = 0
GENESIS_SLOT = 0

# BLS signature/pubkey byte lengths
PUBKEY_BYTES = 48
SIGNATURE_BYTES = 96

# Participation flag indices / weights (altair)
TIMELY_SOURCE_FLAG_INDEX = 0
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2
TIMELY_SOURCE_WEIGHT = 14
TIMELY_TARGET_WEIGHT = 26
TIMELY_HEAD_WEIGHT = 14
SYNC_REWARD_WEIGHT = 2
PROPOSER_WEIGHT = 8
WEIGHT_DENOMINATOR = 64
PARTICIPATION_FLAG_WEIGHTS = [
    TIMELY_SOURCE_WEIGHT,
    TIMELY_TARGET_WEIGHT,
    TIMELY_HEAD_WEIGHT,
]

DEPOSIT_CONTRACT_TREE_DEPTH = 32
JUSTIFICATION_BITS_LENGTH = 4


@dataclass(frozen=True)
class Spec:
    name: str

    # ---- preset tier (EthSpec analog: fixed container sizes) ----
    SLOTS_PER_EPOCH: int
    MAX_COMMITTEES_PER_SLOT: int
    TARGET_COMMITTEE_SIZE: int
    MAX_VALIDATORS_PER_COMMITTEE: int
    SHUFFLE_ROUND_COUNT: int
    EPOCHS_PER_ETH1_VOTING_PERIOD: int
    SLOTS_PER_HISTORICAL_ROOT: int
    EPOCHS_PER_HISTORICAL_VECTOR: int
    EPOCHS_PER_SLASHINGS_VECTOR: int
    HISTORICAL_ROOTS_LIMIT: int
    VALIDATOR_REGISTRY_LIMIT: int
    MAX_PROPOSER_SLASHINGS: int
    MAX_ATTESTER_SLASHINGS: int
    MAX_ATTESTATIONS: int
    MAX_DEPOSITS: int
    MAX_VOLUNTARY_EXITS: int
    SYNC_COMMITTEE_SIZE: int
    EPOCHS_PER_SYNC_COMMITTEE_PERIOD: int
    MIN_SYNC_COMMITTEE_PARTICIPANTS: int

    # ---- runtime tier (ChainSpec analog) ----
    SECONDS_PER_SLOT: int
    MIN_GENESIS_ACTIVE_VALIDATOR_COUNT: int
    MIN_GENESIS_TIME: int
    GENESIS_DELAY: int
    GENESIS_FORK_VERSION: bytes
    ALTAIR_FORK_VERSION: bytes
    ALTAIR_FORK_EPOCH: int
    BELLATRIX_FORK_VERSION: bytes
    BELLATRIX_FORK_EPOCH: int

    MIN_DEPOSIT_AMOUNT: int
    MAX_EFFECTIVE_BALANCE: int
    EFFECTIVE_BALANCE_INCREMENT: int
    EJECTION_BALANCE: int

    MIN_ATTESTATION_INCLUSION_DELAY: int
    MIN_SEED_LOOKAHEAD: int
    MAX_SEED_LOOKAHEAD: int
    MIN_EPOCHS_TO_INACTIVITY_PENALTY: int
    MIN_VALIDATOR_WITHDRAWABILITY_DELAY: int
    SHARD_COMMITTEE_PERIOD: int
    ETH1_FOLLOW_DISTANCE: int
    SECONDS_PER_ETH1_BLOCK: int

    MIN_PER_EPOCH_CHURN_LIMIT: int
    CHURN_LIMIT_QUOTIENT: int

    BASE_REWARD_FACTOR: int
    WHISTLEBLOWER_REWARD_QUOTIENT: int
    PROPOSER_REWARD_QUOTIENT: int
    HYSTERESIS_QUOTIENT: int
    HYSTERESIS_DOWNWARD_MULTIPLIER: int
    HYSTERESIS_UPWARD_MULTIPLIER: int

    # slashing penalties (phase0 / altair variants)
    INACTIVITY_PENALTY_QUOTIENT: int
    MIN_SLASHING_PENALTY_QUOTIENT: int
    PROPORTIONAL_SLASHING_MULTIPLIER: int
    INACTIVITY_PENALTY_QUOTIENT_ALTAIR: int
    MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR: int
    PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR: int
    INACTIVITY_SCORE_BIAS: int
    INACTIVITY_SCORE_RECOVERY_RATE: int

    PROPOSER_SCORE_BOOST: int
    TARGET_AGGREGATORS_PER_COMMITTEE: int

    # sync-committee gossip plane (altair p2p spec; reference
    # consensus/types/src/consts.rs SYNC_COMMITTEE_SUBNET_COUNT and
    # sync_selection_proof.rs TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE)
    SYNC_COMMITTEE_SUBNET_COUNT: int = 4
    TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE: int = 16

    # attestation gossip plane (phase0 p2p spec ATTESTATION_SUBNET_COUNT;
    # reference consensus/types/src/subnet_id.rs — committees shard onto
    # 64 `beacon_attestation_{id}` topics)
    ATTESTATION_SUBNET_COUNT: int = 64

    # blob data-availability plane (EIP-4844 / deneb-shaped, served by
    # the in-repo KZG subsystem — lighthouse_tpu_torch.kzg). Blob size must be
    # a power of two; the dev trusted setup is built lazily per size.
    FIELD_ELEMENTS_PER_BLOB: int = 4096
    BYTES_PER_FIELD_ELEMENT: int = 32
    MAX_BLOBS_PER_BLOCK: int = 6
    MAX_BLOB_COMMITMENTS_PER_BLOCK: int = 4096
    BLOB_SIDECAR_SUBNET_COUNT: int = 6
    # retention window: sidecars older than this many epochs behind the
    # finalized slot are pruned from the store (deneb
    # MIN_EPOCHS_FOR_BLOB_SIDECARS_REQUESTS)
    MIN_EPOCHS_FOR_BLOB_SIDECARS_REQUESTS: int = 4096

    # column data-availability sampling plane (PeerDAS-shaped, served
    # by lighthouse_tpu_torch.da): each blob polynomial is Reed-Solomon
    # extended 2x and split into cells of FIELD_ELEMENTS_PER_CELL
    # evaluations; column k = cell k of every blob in the block. Cell
    # size must divide the extended domain (2 * FIELD_ELEMENTS_PER_BLOB)
    # and the subnet count must divide NUMBER_OF_COLUMNS.
    FIELD_ELEMENTS_PER_CELL: int = 64
    DATA_COLUMN_SIDECAR_SUBNET_COUNT: int = 128
    CUSTODY_REQUIREMENT: int = 4
    SAMPLES_PER_SLOT: int = 8

    # bellatrix (merge) — execution payload sizes + penalty variants
    # (consensus/types/src/eth_spec.rs MaxBytesPerTransaction etc.,
    # chain_spec.rs *_bellatrix fields)
    MAX_BYTES_PER_TRANSACTION: int = 2**30
    MAX_TRANSACTIONS_PER_PAYLOAD: int = 2**20
    BYTES_PER_LOGS_BLOOM: int = 256
    MAX_EXTRA_DATA_BYTES: int = 32
    INACTIVITY_PENALTY_QUOTIENT_BELLATRIX: int = 2**24
    MIN_SLASHING_PENALTY_QUOTIENT_BELLATRIX: int = 32
    PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX: int = 3
    TERMINAL_TOTAL_DIFFICULTY: int = 2**256 - 2**10
    TERMINAL_BLOCK_HASH: bytes = b"\x00" * 32
    TERMINAL_BLOCK_HASH_ACTIVATION_EPOCH: int = FAR_FUTURE_EPOCH

    # domains (4-byte little-endian type tags)
    DOMAIN_BEACON_PROPOSER: bytes = b"\x00\x00\x00\x00"
    DOMAIN_BEACON_ATTESTER: bytes = b"\x01\x00\x00\x00"
    DOMAIN_RANDAO: bytes = b"\x02\x00\x00\x00"
    DOMAIN_DEPOSIT: bytes = b"\x03\x00\x00\x00"
    DOMAIN_VOLUNTARY_EXIT: bytes = b"\x04\x00\x00\x00"
    DOMAIN_SELECTION_PROOF: bytes = b"\x05\x00\x00\x00"
    DOMAIN_AGGREGATE_AND_PROOF: bytes = b"\x06\x00\x00\x00"
    DOMAIN_SYNC_COMMITTEE: bytes = b"\x07\x00\x00\x00"
    DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF: bytes = b"\x08\x00\x00\x00"
    DOMAIN_CONTRIBUTION_AND_PROOF: bytes = b"\x09\x00\x00\x00"
    # builder specs (not an in-protocol domain): signs BuilderBid and
    # ValidatorRegistrationData against the GENESIS fork version with a
    # zero genesis_validators_root (compute_builder_domain in the
    # reference, consensus/types/src/chain_spec.rs)
    DOMAIN_APPLICATION_BUILDER: bytes = b"\x00\x00\x00\x01"

    # ---- derived helpers ----

    @property
    def NUMBER_OF_COLUMNS(self) -> int:
        """Cells per extended blob — derived, so presets cannot drift:
        the 2x-extended domain split into FIELD_ELEMENTS_PER_CELL
        chunks (mainnet: 2*4096/64 = 128)."""
        return (
            2 * self.FIELD_ELEMENTS_PER_BLOB // self.FIELD_ELEMENTS_PER_CELL
        )

    def slot_to_epoch(self, slot: int) -> int:
        return slot // self.SLOTS_PER_EPOCH

    def epoch_start_slot(self, epoch: int) -> int:
        return epoch * self.SLOTS_PER_EPOCH

    def fork_name_at_epoch(self, epoch: int) -> str:
        if epoch >= self.BELLATRIX_FORK_EPOCH:
            return "bellatrix"
        if epoch >= self.ALTAIR_FORK_EPOCH:
            return "altair"
        return "phase0"

    def fork_version_at_epoch(self, epoch: int) -> bytes:
        return {
            "phase0": self.GENESIS_FORK_VERSION,
            "altair": self.ALTAIR_FORK_VERSION,
            "bellatrix": self.BELLATRIX_FORK_VERSION,
        }[self.fork_name_at_epoch(epoch)]

    # fork-keyed penalty parameters (chain_spec.rs *_altair/*_bellatrix)

    def inactivity_penalty_quotient_for(self, fork: str) -> int:
        return {
            "phase0": self.INACTIVITY_PENALTY_QUOTIENT,
            "altair": self.INACTIVITY_PENALTY_QUOTIENT_ALTAIR,
            "bellatrix": self.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX,
        }[fork]

    def min_slashing_penalty_quotient_for(self, fork: str) -> int:
        return {
            "phase0": self.MIN_SLASHING_PENALTY_QUOTIENT,
            "altair": self.MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR,
            "bellatrix": self.MIN_SLASHING_PENALTY_QUOTIENT_BELLATRIX,
        }[fork]

    def proportional_slashing_multiplier_for(self, fork: str) -> int:
        return {
            "phase0": self.PROPORTIONAL_SLASHING_MULTIPLIER,
            "altair": self.PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR,
            "bellatrix": self.PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX,
        }[fork]


def mainnet_spec(**overrides) -> Spec:
    """Mainnet preset + config (chain_spec.rs:431 `ChainSpec::mainnet` and
    eth_spec.rs:238 `MainnetEthSpec` in the reference)."""
    base = Spec(
        name="mainnet",
        SLOTS_PER_EPOCH=32,
        MAX_COMMITTEES_PER_SLOT=64,
        TARGET_COMMITTEE_SIZE=128,
        MAX_VALIDATORS_PER_COMMITTEE=2048,
        SHUFFLE_ROUND_COUNT=90,
        EPOCHS_PER_ETH1_VOTING_PERIOD=64,
        SLOTS_PER_HISTORICAL_ROOT=8192,
        EPOCHS_PER_HISTORICAL_VECTOR=65536,
        EPOCHS_PER_SLASHINGS_VECTOR=8192,
        HISTORICAL_ROOTS_LIMIT=2**24,
        VALIDATOR_REGISTRY_LIMIT=2**40,
        MAX_PROPOSER_SLASHINGS=16,
        MAX_ATTESTER_SLASHINGS=2,
        MAX_ATTESTATIONS=128,
        MAX_DEPOSITS=16,
        MAX_VOLUNTARY_EXITS=16,
        SYNC_COMMITTEE_SIZE=512,
        EPOCHS_PER_SYNC_COMMITTEE_PERIOD=256,
        MIN_SYNC_COMMITTEE_PARTICIPANTS=1,
        SECONDS_PER_SLOT=12,
        MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=16384,
        MIN_GENESIS_TIME=1606824000,
        GENESIS_DELAY=604800,
        GENESIS_FORK_VERSION=bytes.fromhex("00000000"),
        ALTAIR_FORK_VERSION=bytes.fromhex("01000000"),
        ALTAIR_FORK_EPOCH=74240,
        BELLATRIX_FORK_VERSION=bytes.fromhex("02000000"),
        BELLATRIX_FORK_EPOCH=FAR_FUTURE_EPOCH,
        MIN_DEPOSIT_AMOUNT=10**9,
        MAX_EFFECTIVE_BALANCE=32 * 10**9,
        EFFECTIVE_BALANCE_INCREMENT=10**9,
        EJECTION_BALANCE=16 * 10**9,
        MIN_ATTESTATION_INCLUSION_DELAY=1,
        MIN_SEED_LOOKAHEAD=1,
        MAX_SEED_LOOKAHEAD=4,
        MIN_EPOCHS_TO_INACTIVITY_PENALTY=4,
        MIN_VALIDATOR_WITHDRAWABILITY_DELAY=256,
        SHARD_COMMITTEE_PERIOD=256,
        ETH1_FOLLOW_DISTANCE=2048,
        SECONDS_PER_ETH1_BLOCK=14,
        MIN_PER_EPOCH_CHURN_LIMIT=4,
        CHURN_LIMIT_QUOTIENT=65536,
        BASE_REWARD_FACTOR=64,
        WHISTLEBLOWER_REWARD_QUOTIENT=512,
        PROPOSER_REWARD_QUOTIENT=8,
        HYSTERESIS_QUOTIENT=4,
        HYSTERESIS_DOWNWARD_MULTIPLIER=1,
        HYSTERESIS_UPWARD_MULTIPLIER=5,
        INACTIVITY_PENALTY_QUOTIENT=2**26,
        MIN_SLASHING_PENALTY_QUOTIENT=128,
        PROPORTIONAL_SLASHING_MULTIPLIER=1,
        INACTIVITY_PENALTY_QUOTIENT_ALTAIR=3 * 2**24,
        MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR=64,
        PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR=2,
        INACTIVITY_SCORE_BIAS=4,
        INACTIVITY_SCORE_RECOVERY_RATE=16,
        PROPOSER_SCORE_BOOST=40,
        TARGET_AGGREGATORS_PER_COMMITTEE=16,
    )
    return replace(base, **overrides) if overrides else base


def minimal_spec(**overrides) -> Spec:
    """Minimal preset (eth_spec.rs:281 `MinimalEthSpec`): small committees
    and short vectors for fast in-process testing."""
    base = replace(
        mainnet_spec(),
        name="minimal",
        SLOTS_PER_EPOCH=8,
        MAX_COMMITTEES_PER_SLOT=4,
        TARGET_COMMITTEE_SIZE=4,
        SHUFFLE_ROUND_COUNT=10,
        EPOCHS_PER_ETH1_VOTING_PERIOD=4,
        SLOTS_PER_HISTORICAL_ROOT=64,
        EPOCHS_PER_HISTORICAL_VECTOR=64,
        EPOCHS_PER_SLASHINGS_VECTOR=64,
        HISTORICAL_ROOTS_LIMIT=2**24,
        SYNC_COMMITTEE_SIZE=32,
        EPOCHS_PER_SYNC_COMMITTEE_PERIOD=8,
        MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=64,
        ETH1_FOLLOW_DISTANCE=16,
        MIN_VALIDATOR_WITHDRAWABILITY_DELAY=256,
        SHARD_COMMITTEE_PERIOD=64,
        MIN_GENESIS_TIME=1578009600,
        GENESIS_DELAY=300,
        GENESIS_FORK_VERSION=bytes.fromhex("00000001"),
        ALTAIR_FORK_VERSION=bytes.fromhex("01000001"),
        BELLATRIX_FORK_VERSION=bytes.fromhex("02000001"),
        # tiny blobs keep the dev trusted setup and the KZG data plane
        # fast enough for in-process testing (minimal-preset role)
        FIELD_ELEMENTS_PER_BLOB=4,
        MAX_BLOBS_PER_BLOCK=4,
        MAX_BLOB_COMMITMENTS_PER_BLOCK=16,
        BLOB_SIDECAR_SUBNET_COUNT=4,
        MIN_EPOCHS_FOR_BLOB_SIDECARS_REQUESTS=4,
        # tiny DAS geometry: 4-element blobs extend to 8 evaluations,
        # split into 4 columns of 2-element cells over 4 subnets
        FIELD_ELEMENTS_PER_CELL=2,
        DATA_COLUMN_SIDECAR_SUBNET_COUNT=4,
        CUSTODY_REQUIREMENT=2,
        SAMPLES_PER_SLOT=2,
    )
    return replace(base, **overrides) if overrides else base


def gnosis_spec(**overrides) -> Spec:
    """Gnosis chain preset + config (eth_spec.rs:327 `GnosisEthSpec`,
    chain_spec.rs:637 `ChainSpec::gnosis`): mainnet container sizes with
    5 s slots, xDai-denominated deposits kept at the same gwei values,
    faster eth1 follow, and gnosis fork versions."""
    base = replace(
        mainnet_spec(),
        name="gnosis",
        SLOTS_PER_EPOCH=16,
        SECONDS_PER_SLOT=5,
        MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=4096,
        MIN_GENESIS_TIME=1638968400,
        GENESIS_DELAY=6000,
        GENESIS_FORK_VERSION=bytes.fromhex("00000064"),
        ALTAIR_FORK_VERSION=bytes.fromhex("01000064"),
        ALTAIR_FORK_EPOCH=256,
        BELLATRIX_FORK_VERSION=bytes.fromhex("02000064"),
        ETH1_FOLLOW_DISTANCE=1024,
        SECONDS_PER_ETH1_BLOCK=6,
        CHURN_LIMIT_QUOTIENT=4096,
        BASE_REWARD_FACTOR=25,
    )
    return replace(base, **overrides) if overrides else base


def spec_from_config_yaml(text: str, base: Spec | None = None) -> Spec:
    """Build a Spec from a consensus config.yaml (the runtime-tier override
    file every network directory carries — eth2_network_config's
    config.yaml + config_and_preset.rs). Minimal YAML subset: `KEY: value`
    lines, comments, 0x-hex and decimal scalars, named presets via
    PRESET_BASE."""
    values: dict[str, object] = {}
    preset_base = "mainnet"
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line or ":" not in line:
            continue
        key, _, val = line.partition(":")
        key, val = key.strip(), val.strip().strip("'\"")
        if key == "PRESET_BASE":
            preset_base = val
            continue
        if val.startswith("0x"):
            values[key] = bytes.fromhex(val[2:])
        elif val.isdigit():
            values[key] = int(val)
        else:
            values[key] = val
    if base is None:
        base = {
            "mainnet": mainnet_spec,
            "minimal": minimal_spec,
            "gnosis": gnosis_spec,
        }.get(preset_base, mainnet_spec)()
    known = {f.name for f in fields(Spec)}
    overrides = {k: v for k, v in values.items() if k in known}
    if "CONFIG_NAME" in values:
        overrides["name"] = str(values["CONFIG_NAME"])
    return replace(base, **overrides)


def spec_to_config_yaml(spec: Spec) -> str:
    """Serialize a Spec as a consensus config.yaml — the exact inverse of
    `spec_from_config_yaml` (every field is emitted, so the named
    PRESET_BASE only seeds defaults the override lines then pin). This is
    what `lcli new-testnet` writes into a --testnet-dir and what the
    embedded network-config assets are generated from
    (eth2_network_config's config.yaml role)."""
    preset = spec.name if spec.name in ("mainnet", "minimal", "gnosis") \
        else "mainnet"
    lines = [
        f"# {spec.name} — generated by lighthouse_tpu_torch "
        "(spec_to_config_yaml)",
        f"PRESET_BASE: '{preset}'",
        f"CONFIG_NAME: '{spec.name}'",
    ]
    for f in fields(Spec):
        if f.name == "name":
            continue
        v = getattr(spec, f.name)
        if isinstance(v, bytes):
            lines.append(f"{f.name}: 0x{v.hex()}")
        else:
            lines.append(f"{f.name}: {v}")
    return "\n".join(lines) + "\n"
