"""Host utilities: audio IO."""
