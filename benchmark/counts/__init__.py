"""Operations and bytes of the cells' work, counted over the plain
reference at the cells' shapes, so that they stay fixed whatever the
program does."""
