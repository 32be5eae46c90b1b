"""The sparse support plane: blocked-ELL containers and the ELL SpMM."""
