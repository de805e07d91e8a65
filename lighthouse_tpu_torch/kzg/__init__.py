from lighthouse_tpu_torch.kzg.api import (  # noqa: F401
    BYTES_PER_FIELD_ELEMENT,
    KzgError,
    blob_to_kzg_commitment,
    blob_to_polynomial,
    compute_blob_kzg_proof,
    compute_challenge,
    compute_kzg_proof,
    evaluate_polynomial,
    verify_blob_kzg_proof,
    verify_blob_kzg_proof_batch,
    verify_kzg_proof,
)
from lighthouse_tpu_torch.kzg.trusted_setup import (  # noqa: F401
    TrustedSetup,
    dev_setup,
)
