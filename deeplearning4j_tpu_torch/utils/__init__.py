"""Host-side utilities (the bucket ladder, the misc reference utilities)."""
