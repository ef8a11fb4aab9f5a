"""Report generation: HTML / Markdown / DOCX (port of the JAX package's
``analysis/report.py``, host only).

DOCX through a minimal self-contained OOXML writer (zip + document.xml),
beside HTML and Markdown writers of the same structure: title, one table a
section, the figures embedded.
"""

from __future__ import annotations

import datetime
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional
from xml.sax.saxutils import escape

from multimodal_organ_segmentation_tpu_torch.utils.io import ensure_dir


def _flatten_tables(results: Dict[str, Any]) -> Dict[str, List[Dict[str, Any]]]:
    """results → {section: rows}; rows are flat dicts."""
    tables: Dict[str, List[Dict[str, Any]]] = {}
    for section, content in (results or {}).items():
        if isinstance(content, dict) and "organs" in content:
            tables[section] = [
                r if isinstance(r, dict) else {"organ": r} for r in content["organs"]
            ]
        elif isinstance(content, dict):
            rows = []
            for key, value in content.items():
                if isinstance(value, dict):
                    rows.append({"metric": key, **value})
                else:
                    rows.append({"metric": key, "value": value})
            tables[section] = rows
        elif isinstance(content, list):
            tables[section] = [
                r if isinstance(r, dict) else {"value": r} for r in content
            ]
    return tables


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)


class ReportGenerator:
    """Generate analysis reports in markdown / html / docx."""

    def __init__(self, config=None):
        self.config = config
        self.title = "Multi-Modal Organ Segmentation Analysis Report"

    def generate(
        self,
        results: Dict[str, Any],
        output_path,
        formats: Optional[List[str]] = None,
    ) -> Dict[str, str]:
        output_path = ensure_dir(output_path)
        formats = formats or ["markdown", "html", "docx"]
        written = {}
        figures = self._collect_figures(results, output_path)
        if "markdown" in formats:
            written["markdown"] = self.generate_markdown(results, output_path, figures)
        if "html" in formats:
            written["html"] = self.generate_html(results, output_path, figures)
        if "docx" in formats:
            written["docx"] = self.generate_docx(results, output_path)
        return written

    def _collect_figures(self, results, output_path) -> List[str]:
        figs = []
        hist = (results or {}).get("histogram", {})
        if isinstance(hist, dict):
            figs.extend(hist.get("figures", []))
        return figs

    # -- markdown ------------------------------------------------------------

    def generate_markdown(self, results, output_path, figures=None) -> str:
        lines = [f"# {self.title}", "",
                 f"Generated: {datetime.datetime.now().isoformat(timespec='seconds')}", ""]
        for section, rows in _flatten_tables(results).items():
            lines.append(f"## {section.upper()}")
            lines.append("")
            if rows:
                cols = list(rows[0].keys())
                lines.append("| " + " | ".join(cols) + " |")
                lines.append("|" + "---|" * len(cols))
                for r in rows:
                    lines.append(
                        "| " + " | ".join(_fmt(r.get(c, "")) for c in cols) + " |"
                    )
            lines.append("")
        for fig in figures or []:
            lines.append(f"![figure]({Path(fig).name})")
        out = Path(output_path) / "report.md"
        out.write_text("\n".join(lines))
        return str(out)

    # -- html ------------------------------------------------------------------

    def generate_html(self, results, output_path, figures=None) -> str:
        parts = [
            "<html><head><meta charset='utf-8'>",
            f"<title>{escape(self.title)}</title>",
            "<style>body{font-family:sans-serif;margin:2em} "
            "table{border-collapse:collapse} td,th{border:1px solid #999;"
            "padding:4px 8px} th{background:#eee}</style></head><body>",
            f"<h1>{escape(self.title)}</h1>",
            f"<p>Generated: {datetime.datetime.now().isoformat(timespec='seconds')}</p>",
        ]
        for section, rows in _flatten_tables(results).items():
            parts.append(f"<h2>{escape(section.upper())}</h2>")
            if rows:
                cols = list(rows[0].keys())
                parts.append("<table><tr>" + "".join(f"<th>{escape(c)}</th>" for c in cols) + "</tr>")
                for r in rows:
                    parts.append(
                        "<tr>" + "".join(f"<td>{escape(_fmt(r.get(c, '')))}</td>" for c in cols) + "</tr>"
                    )
                parts.append("</table>")
        for fig in figures or []:
            parts.append(f"<img src='{escape(Path(fig).name)}' style='max-width:100%'>")
        parts.append("</body></html>")
        out = Path(output_path) / "report.html"
        out.write_text("\n".join(parts))
        return str(out)

    # -- docx --------------------------------------------------------------------

    def generate_docx(self, results, output_path) -> str:
        """Minimal OOXML .docx: headings + tables."""

        def para(text, style=None):
            props = f"<w:pPr><w:pStyle w:val=\"{style}\"/></w:pPr>" if style else ""
            return (
                f"<w:p>{props}<w:r><w:t xml:space=\"preserve\">{escape(text)}"
                "</w:t></w:r></w:p>"
            )

        def table(rows):
            cols = list(rows[0].keys())
            def cell(text):
                return (
                    "<w:tc><w:tcPr><w:tcBorders>"
                    + "".join(
                        f"<w:{side} w:val=\"single\" w:sz=\"4\"/>"
                        for side in ("top", "left", "bottom", "right")
                    )
                    + "</w:tcBorders></w:tcPr>"
                    + para(text)
                    + "</w:tc>"
                )
            body = "<w:tr>" + "".join(cell(c) for c in cols) + "</w:tr>"
            for r in rows:
                body += "<w:tr>" + "".join(cell(_fmt(r.get(c, ""))) for c in cols) + "</w:tr>"
            return f"<w:tbl><w:tblPr/><w:tblGrid/>{body}</w:tbl>"

        content = [para(self.title, "Heading1")]
        content.append(
            para(f"Generated: {datetime.datetime.now().isoformat(timespec='seconds')}")
        )
        for section, rows in _flatten_tables(results).items():
            content.append(para(section.upper(), "Heading2"))
            if rows:
                content.append(table(rows))
                content.append(para(""))

        document = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<w:document xmlns:w="http://schemas.openxmlformats.org/wordprocessingml/2006/main">'
            f"<w:body>{''.join(content)}</w:body></w:document>"
        )
        content_types = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
            '<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
            '<Default Extension="xml" ContentType="application/xml"/>'
            '<Override PartName="/word/document.xml" ContentType="application/vnd.openxmlformats-officedocument.wordprocessingml.document.main+xml"/>'
            "</Types>"
        )
        rels = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
            '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="word/document.xml"/>'
            "</Relationships>"
        )
        out = Path(output_path) / "report.docx"
        with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("[Content_Types].xml", content_types)
            z.writestr("_rels/.rels", rels)
            z.writestr("word/document.xml", document)
        return str(out)
