"""The paper's measured DL serving points, copied from the numpy layer."""
