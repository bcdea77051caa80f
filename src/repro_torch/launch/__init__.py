"""Step builders for serving."""
