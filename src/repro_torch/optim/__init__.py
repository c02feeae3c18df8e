"""AdamW of the port."""
