"""Diagnostic timing scripts for the card; nothing here runs on import."""
