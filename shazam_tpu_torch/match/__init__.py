"""Query preparation, matching, vote ranking and result assembly."""
