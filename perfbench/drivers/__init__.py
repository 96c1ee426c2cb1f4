"""One driver per kind of traffic mix (a mix file's ``kind``)."""
