"""Scene data: host storage (numpy), device views (torch), lights, procedural scenes."""
