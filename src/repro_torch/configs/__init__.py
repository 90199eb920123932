"""The paper's experimental scenarios."""
