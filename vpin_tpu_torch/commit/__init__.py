from .pedersen import (
    MultiCommitGens, commit_scalar, commit_vec_dev, commit_vec_ints,
    hyrax_commit, hyrax_commit_host, msm_points,
)

__all__ = ["MultiCommitGens", "commit_scalar", "commit_vec_dev",
           "commit_vec_ints", "hyrax_commit", "hyrax_commit_host",
           "msm_points"]
