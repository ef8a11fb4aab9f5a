"""Minimal XLSX writer (no openpyxl) and the analysis tables' CSV + XLSX
(port of the JAX package's ``utils/xlsx.py``).

XLSX is a zip of XML parts; ``write_xlsx`` writes the minimal set (content
types, rels, workbook, one worksheet with inline strings). ``save_table``
writes a list of row dicts as the JAX package's ``pandas.DataFrame`` of them
does with ``to_csv(index=False)`` and ``dataframe_to_xlsx``, without pandas:
the columns in order of first appearance, a numeric column with a float or
a missing value held as floats, a missing value empty in the CSV and
``nan`` in the XLSX.
"""

from __future__ import annotations

import csv
import math
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple
from xml.sax.saxutils import escape

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets>
</workbook>"""

_WB_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
</Relationships>"""


def _col_name(idx: int) -> str:
    name = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        name = chr(65 + rem) + name
    return name


def _cell_xml(row: int, col: int, value: Any) -> str:
    ref = f"{_col_name(col)}{row + 1}"
    if isinstance(value, bool):
        return f'<c r="{ref}" t="b"><v>{int(value)}</v></c>'
    if isinstance(value, (int, float)) and value == value and value not in (
        float("inf"), float("-inf"),
    ):
        return f'<c r="{ref}"><v>{value!r}</v></c>'
    text = escape(str(value))
    return f'<c r="{ref}" t="inlineStr"><is><t>{text}</t></is></c>'


def write_xlsx(rows: Sequence[Sequence[Any]], path) -> None:
    """Write rows (first row = header) to an xlsx file."""
    body = []
    for r, row in enumerate(rows):
        cells = "".join(_cell_xml(r, c, v) for c, v in enumerate(row))
        body.append(f'<row r="{r + 1}">{cells}</row>')
    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
        f"<sheetData>{''.join(body)}</sheetData></worksheet>"
    )
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK)
        z.writestr("xl/_rels/workbook.xml.rels", _WB_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet)


_MISSING = float("nan")


def _is_number(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def records_table(records: List[Dict[str, Any]]) -> Tuple[List[str], List[List[Any]]]:
    """Row dicts → (columns, rows) as a DataFrame of them holds them: the
    columns in order of first appearance, missing values NaN, and a column
    of numbers with a float or a NaN in it all floats."""
    columns: List[str] = []
    for r in records:
        columns.extend(k for k in r if k not in columns)
    rows = [[r.get(c, _MISSING) for c in columns] for r in records]
    for j, c in enumerate(columns):
        values = [row[j] for row in rows]
        if all(_is_number(v) for v in values) and any(isinstance(v, float) for v in values):
            for row in rows:
                row[j] = float(row[j])
    return columns, rows


def _csv_value(v: Any) -> Any:
    return "" if isinstance(v, float) and math.isnan(v) else v


def save_table(records: List[Dict[str, Any]], csv_path, xlsx_path=None) -> None:
    """Row dicts as CSV (+ XLSX, as the reference's ``to_excel``)."""
    columns, rows = records_table(records)
    Path(csv_path).parent.mkdir(parents=True, exist_ok=True)
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        w.writerows([[_csv_value(v) for v in row] for row in rows])
    if xlsx_path is not None:
        write_xlsx([columns] + rows, xlsx_path)
