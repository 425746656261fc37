"""Host-side bounds and the SAH tree build that the cluster build cuts."""
